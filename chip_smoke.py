"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --decode-only [DIR]
    python3 chip_smoke.py --sparse-only [DIR]
    python3 chip_smoke.py --ckpt-only [DIR]
    python3 chip_smoke.py --gpt2-only
    python3 chip_smoke.py --serve-prefix-only
    python3 chip_smoke.py --serve-chaos-only
    python3 chip_smoke.py --sentinel-only [--profile]
    python3 chip_smoke.py --fp16-only [--profile]
    python3 chip_smoke.py --quant-train-only
    python3 chip_smoke.py --observability-only
    python3 chip_smoke.py --rl-only [--profile]
    python3 chip_smoke.py --dp-only
    python3 chip_smoke.py --zero3-only [--profile]
    python3 chip_smoke.py --moe-ep-only

Phases (any failure exits non-zero before the final line):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the hand-written kernels from deeperspeed_tpu_torch/csrc, and
   what the grouped dW, the block-sparse tensor-core forward, dK/dV and
   dQ (which must not spill) and the paged-decode cluster kernels take
   on the card (registers, spills, static and dynamic shared memory,
   blocks an SM);
3. kernels: each kernel against its plain PyTorch version, in bf16 and
   fp32, with its time, the plain version's time, a library call's time
   (timed only) and its bound: flash forward at the serving shapes and
   at the training shape, flash backward at the training shape and on
   ragged segments (timed at B=4, S=1024), paged decode over bf16/fp32
   and over int8 pools at the serving shape and at head dims 128 and 256
   (two calls bit-identical), timed in CUDA graphs cold (cycling through
   the pools of as many layers as it takes to read 64 MB between two
   uses of one) and warm, beside the parent's single-block kernel and
   SDPA, over lengths 0-1024 and over serve-quant's 62-110, the
   weight-only int8 matmul
   (bf16: the wgmma kernel) at M = 16, 256 and 4096 for the four block
   weights, its int8 widening read out bit for bit (one-hot x over all
   256 int8 values), two calls bit-identical, and the wrapper's host
   microseconds a call at M = 16, flat Adam at the model's
   parameter count, the grouped matmul's forward (bf16: the wgmma
   kernel, also dx) and dW kernels at the MoE training geometry (8 spans
   of 2560 rows, ragged sizes with an empty expert, (K, N) = (768, 3072)
   and (3072, 768)) and on a LUT whose weights own several spans:
   outputs, dx through the autograd function and the fp32 dW, exact
   zeros on dead rows and for an empty expert, two forward, dx and dW
   calls bit-identical, and spans no tile divides with NaN-filled dead
   rows (the dW finite and equal to the plain version); the
   block-sparse forward, dk/dv and dq kernels at phase 13's attention
   shape (B=2, S=16384, H=12, D=64, fixed l16g1 causal) with dq, dk, dv
   also through the autograd function, two bf16 calls of each kernel
   bit-identical, on a causal bf16 layout at D = 128 (B=2, S=2048, H=4,
   l4g1), and on a bidirectional
   layout with a dead row at head dims 64, 128 and 256; the layout-masked
   flash forward and backward at phase 14(a)'s shape (B=16, S=1024,
   l4g1) and on the dead-row layout; each timed beside SDPA under the
   token mask, the port's dense causal flash and the other sparse arm;
   and both sparse arms timed on four layouts of density 0.12-0.53 at
   B=8, S=2048, where they cross; the flash forward and backward with
   the key-bias and dropout flags at BERT-large's shape (B=20, S=512,
   H=16, D=64, not causal), rates 0 and 0.1, exact zeros on an
   all-masked batch row, timed beside SDPA under the float mask, and the
   fused and materialized attention paths timed at S = 128 and 512; the
   keep-mask the bf16 forward and dk/dv kernels draw at that shape, read
   out of their outputs (q = k = 0, a one-hot v or dO, S/D calls each)
   and held bit for bit against `dropout_keep`; two bf16 backward calls
   on the same inputs compared bit for bit (training and BERT shapes);
   the bf16 flash kernels at D = 64 and 128 are the tensor-core design,
   fp32 and D = 256 the FMA one; the segmented flash forward and
   backward on packed documents, against their plain versions at S 4096
   (bf16 and fp32) and at phase 18's shape (B=2, S=16384, H=12, D=64,
   its rows' segments; the plain version one batch row and two heads at
   a time), and timed there beside SDPA under the same bool mask, the
   bound over the live pairs (the plain version is timed at S 4096
   only); phase 2 prints every kernel's registers and spills
   (`-Xptxas -v`);
4. serving: GPT-NeoX-125M at full width (seeded random bf16 weights)
   serves 32 requests through `InferenceEngine` with every kernel
   launch counted (every flash launch of phases 4, 7, 11 and 15 on the
   tensor-core design, every paged-decode launch of phases 4 and 9 on
   the cluster design, by the wrappers' per-design counters);
5. parity: the same model in fp32 gives the same greedy tokens through
   the kernels and through the plain path;
6. profile (only with ``--profile``): `torch.profiler` over a steady
   window of decode steps at B=16, over one B=4, S=512 prefill call of
   the same bf16 model, over a decode window of each serve-quant rung of
   phase 9, over one training step of phase 7, one of phase 11, one of
   phase 13, one of phase 15, one of phase 18, one of each "full"
   rung of phase 20 (lean and classic) and one rl-ppo-125M iteration of
   phase 40: host ms per step, device kernel
   ms per step, the device's busy share, launches per step and the top
   kernels;
7. training: GPT-NeoX-125M at full width and depth, bf16 with fp32
   masters, Adam(W), WarmupLR, clipping, ZeRO-2, gas 2 x micro 16 x
   1024 tokens, 20 steps through `initialize()` → `train_batch` on one
   repeated batch of ids below 512, with every kernel launch counted,
   then one `eval_batch`;
8. training parity: the same model in fp32 (micro 2, gas 2, S 1024)
   takes 3 steps through the kernels and 3 through the plain path; the
   losses must agree;
9. serving-quant: GPT-NeoX-125M (seeded bf16 weights) serves the
   decode-heavy stream of bench.py's row_quant (16 requests x 62 prompt
   tokens x 48 new) at three rungs, bf16, int8 weights, and int8 weights
   with int8 KV pages, each with exact launch counts (every int8 matmul
   launch on the wgmma design), no page leaks and every request ok; plus
   the int8-KV capacity accounting;
10. int8 parity: the fp32 model with int8 weights and int8 KV pages
   gives the same greedy tokens through the kernels and through the
   plain path;
11. MoE training (bench.py's row_moe on one card): the dense
   GPT-NeoX-125M made MoE by the JSON "moe" block (8 experts, top-2,
   capacity factor 1.25, sort dispatch; 559,080,960 parameters), phase
   7's optimizer, schedule, clipping, bf16 and ZeRO-2 at micro 8 x gas 1
   x 1024, 20 steps and one `eval_batch`, with exact launch counts (48
   grouped-matmul forward-kernel launches a step and 24 dW, all on the
   wgmma design, besides 12 flash forward, 12 + 12 flash backward and 1
   Adam);
12. MoE training parity: the same MoE model in fp32 (micro 2, gas 2, S
   1024) takes 3 steps through the kernels and 3 through the plain
   path; the losses must agree;
13. sparse training (bench.py's row_longseq sparse rung on one card):
   GPT-NeoX-125M's widths and depth with an 8192 vocabulary at 16,384
   tokens, the JSON "sparse_attention" block (fixed, 16 local + 1 global
   128-blocks, causal; density 0.094) through `initialize()` →
   `train_batch`, Adam lr 1e-4, bf16, ZeRO-2, micro 2, 10 steps and one
   `eval_batch`, with exact launch counts (12 block-sparse forward, 12
   dk/dv and 12 dq launches a step, every one on the tensor-core
   design, no dense or masked flash launch); then the same 10 steps
   with the bench row's remat ("activation_checkpointing": {"policy":
   "full"}): 24 block-sparse forward, 12 dk/dv and 12 dq launches a
   step, its step ms and peak memory beside the run without;
14. sparse training parity, fp32, 3 steps through the kernels and 3
   through the plain versions of the same arm: (a) the masked flash arm
   on phase 8's GPT-NeoX-125M (S 1024, micro 2 x gas 2, l4g1), (b) the
   block-sparse arm on phase 13's model at S 8192 (micro 1, l16g1), its
   forward, dk/dv and dq launches on the FMA design; the losses must
   agree within rtol
   1e-4;
15. BERT training (bench.py's row_bert512 on one card): BERT-large
   (336,232,258 parameters) through `initialize()` → `train_batch`,
   Adam lr 1e-4, bf16, ZeRO-2, dropout 0.1, micro 20 x 512 tokens with
   an all-ones mask and 15% MLM labels, 10 steps and one `eval_batch`,
   with exact launch counts (24 flash forward, 24 dk/dv and 24 dq
   launches a step, all with the key-bias and dropout flags, 1 Adam)
   and peak memory below 80 GB;
16. BERT training parity, fp32: BERT-large's widths at 4 layers (S 512,
   micro 2 x gas 2, dropout 0.1, a ragged mask), 3 steps through the
   kernels and 3 through the plain versions from generators seeded
   alike; the losses must agree within rtol 1e-4.
17. checkpoint (bench.py's row_ckpt on one card): phase 7's run takes
   6 steps, saves (sync) and takes 4 more; a fresh engine from other
   seed weights loads and every field (masters, moments, compute
   parameters, Adam step, LR schedule, loss scale, counters) must equal
   its value at the save bit for bit; it takes the same 4 steps, every
   flash and Adam launch counted on the tensor-core designs, and the
   losses must agree with the uninterrupted ones within rtol 1e-4
   (whether they are bit-identical is printed); then an async save
   overlapped with steps (row_ckpt's ckpt_step_ms, ckpt_sync_stall_ms,
   ckpt_async_stall_ms, ckpt_async_overlap_steps, ckpt_bytes_mb,
   ckpt_stall_ratio, the load seconds and write MB/s), a corrupted
   newest checkpoint that `load_checkpoint()` must pass over for the
   previous one and must refuse by name, and the checkpoint's own
   zero_to_fp32.py, whose fp32 state dict must equal the masters. The
   checkpoints live in a temporary directory under build/, removed at
   the end;
18. packed long-context training (bench.py's row_packed on one card):
   phase 13's model without the sparse block, the "packing" block and
   "activation_checkpointing": {"policy": "full"} (the row's
   remat_blocks), on the first 2 rows of the row's seeded document
   mixture packed into 16,384-token rows: 10 bf16 steps and one
   `eval_batch` with a falling loss; beside it the no-segment control
   (the same tokens without segment ids or the packing block), the
   no-remat run ("none") and 3 steps each under "dots",
   "attn_residuals" and "offload_dots". Each run counts its launches
   exactly (12 flash forward a step, 24 where the policy recomputes the
   forward: full, dots, offload_dots; 12 dk/dv, 12 dq, all on the
   tensor-core design; one Adam); every policy's 3 losses equal the
   "none" run's bit for bit; peak memory orders full < none,
   attn_residuals <= dots <= none, offload_dots < dots. It reports step
   ms, tokens/s, effective tokens/s, occupancy, the seg/no-seg
   speed-up and each run's peak memory above what was allocated before
   its engine (cuBLAS workspaces released first), and what earlier
   phases left allocated;
19. packed parity, fp32, kernels vs plain: (a) phase 18's model at 4
   layers, S 4096, micro 2, "full" remat, 3 steps each way, losses
   within rtol 1e-4; (b) BERT-large's widths at 4 layers, S 512, 2
   packed rows, attention dropout 0 (hidden dropout 0.1), two remat
   spans: `encode(segment_ids=)` through the non-causal segmented flash
   kernels, loss and gradient within rtol 1e-4;
20. GPT-2 XL training (bench.py's row_gpt2xl on one card; 1,557,686,400
   parameters, seeded bf16 weights made by the port and handed to
   `initialize(model=, model_parameters=)`, the row's default_rng(4)
   tokens): the row's lean bs 8 ladder ("fp16_master_weights_and_grads"
   and bf16 Adam moments; "dots", "attn_residuals", "full"), its floor
   (lean bs 4, whole-block remat) and one classic bs 8 "full" rung (fp32
   masters and moments), 2 warm-up and 3 timed steps each: tokens/s,
   the row's MFU, step ms, peak memory above what was allocated before
   the engine, exact launches (48 flash forward a step, 96 where the
   policy recomputes it, 48 dk/dv, 48 dq, all tensor-core; one Adam on
   the lean or fp32 variant) and a falling loss. The row's last rung
   (ZeRO-3 with the host-offload optimizer) is not ported;
21. the legacy loop on GPT-2 XL (lean, "full", micro 4 x gas 2): three
   steps through forward / backward / step equal three through
   train_batch bit for bit; set_layers_to_hook(["transformerlayer"])
   gives 48 captures of [4, 1024, 1600] from one capture forward and
   disarms; enable_gradient_noise_scale gives a finite estimate;
22. GPT-2 XL served (seeded bf16 weights, phase 4's "inference" block
   and stream): every flash and paged-decode launch counted, all on the
   tensor-core prefill and the cluster decode, no page leaks, every
   request ok; tokens/s, TTFT, inter-token p50 / p99;
23. GPT-2 parity, fp32, kernels vs plain: XL's widths at 4 layers, S
   1024, micro 2 x gas 2, 3 steps each way (losses within rtol 1e-4),
   and the same weights served (the same greedy tokens);
24. serve-prefix-125M (bench.py's row_serve_prefix): GPT-NeoX-125M
   (seeded bf16 weights) behind the row's "inference" block (page 64,
   513 pages, batches of 4 / 8, budget 2048) serves the row's stream (32
   requests, one shared 256-token prefix, every fifth prompt cold, tails
   of 8-48 tokens, 32 new): two streams cache off (the second measured),
   then three with the prefix cache and k = 4 speculation through the
   row's draft (hidden 256, 4 layers, 8 heads of 32; the third
   measured). It reports the row's hit rate, saved tokens, effective
   prefill tokens/s both ways, acceptance, inter-token p50 both ways and
   their ratio, compile_delta (must be 0), and the greedy agreement of
   the two engines on the measured prompts (bf16 rounds the verify's
   plain attention and the kernels' differently); exact launches: 12
   flash forwards a full prefill call (all tensor-core), the cluster
   decode 12 a cache-off decode step, and the draft's (k + 1) x 4 decode
   calls a speculative step on the plain version (head dim 32, as the
   JAX package dispatches); no page leaked, every registered page held
   by the registry alone, every request ok;
25. serve-gpt2xl-spec: the same block and stream through GPT-2 XL and a
   GPT-2 small draft: 48 flash forwards a full prefill call, the draft's
   (k + 1) x 12 decode calls a speculative step all on the bf16 cluster
   kernel, the same invariants and quantities;
26. prefix + speculative parity, fp32: (a) phase 24's pair at 125M
   widths with a 4-layer target, (b) phase 25's pair at XL's and GPT-2
   small's widths, 4 and 2 layers, int8 KV pages and int8 draft weights:
   a shared-prefix stream served twice (misses, then hits) gives the
   same greedy tokens through the kernels, through the plain path
   (launching no kernel) and through a cache-off, non-speculative engine;
   (c) `hot_swap_weights` on (a)'s warm engine drops the registry with
   compile_delta 0 and then serves what a fresh engine on the new weights
   serves, and `restore_sampler_state` makes a second engine draw a
   temperature-0.8 speculative stream token for token;
27. serve-chaos-125M (bench.py's row_serve_chaos): GPT-NeoX-125M (seeded
   bf16 weights) behind the row's "inference" block (page 64, 513 pages,
   batches of 4 / 16, budget 2048, an admission queue of 24, retry 3 x
   5-50 ms, jitter 0.25) serves the row's stream (64 requests,
   lognormal(5.0, 0.8) prompt lengths, 64 new tokens, one submission
   every 2 steps) clean, then under the row's fault storm (decode errors
   at step serials 40, 41 and 120, a 0.05 s decode stall at 80, page-pool
   pressure of 0.7 at 60-64). It reports the row's success rate, shed
   fraction, TTFT p50 / p99, tokens/s, quarantines and evictions, and the
   storm's TTFT p99 degradation; it holds the row's invariants (the
   server stays up, every accepted request reaches exactly one terminal
   status, no page leaks, compile_delta 0), no quarantine or failure in
   the clean stream, as many quarantines in the storm as injected errors
   fired on a step with work of their phase and nothing but injected
   faults caught, a clean `torch.cuda.synchronize()` after each stream,
   and exact launches (12 flash forwards a full prefill call, 12 cluster
   decodes a decode step, all on the tensor-core and cluster designs);
   (b) the same model with a 0.25 s hang timeout and one 1.0 s decode
   stall once every program is warm: the watchdog fires once, its stack
   dump names the threads, `run()` drains every accepted request to one
   terminal status and exits with SystemExit(0); a fresh engine whose
   programs are cold, with a timeout below its steps' times, never fires;
28. chaos parity, fp32, kernels vs plain: (a) phase 26(a)'s pair with the
   prefix cache and k = 4 speculation serves a shared-prefix stream twice
   under transient faults (a prefill error, two decode errors, page-pool
   pressure): every request ends ok with the greedy tokens of a clean
   cache-off engine and of the plain path, no page leaked, the registry
   holding only its own pages; (b) the same with int8 weights (target and
   draft) and int8 KV pages, and a prefill that loses every KV pool
   mid-stream (their storage released), so the engine rebuilds the
   target's and the draft's `QuantizedPages` with `reset_pools` and
   re-prefills what was running;
29. train-sentinel-125M (bench.py's row_sentinel, not cut):
   GPT-NeoX-125M (seeded bf16 weights) behind the row's JSON (Adam lr
   1e-4, bf16, ZeRO-2, gas 1, S 1024). (a) At bs 16 and 8: 3 warm-up and
   8 timed steps with the sentinel off and on (skip_batch, warmup 3),
   then those two engines and a third under policy warn (the same probe,
   no host read before Adam) take 10 alternating rounds of 8 steps
   (medians); the recovery under policy
   rollback: 4 steps, a sync save, NaN gradients at serial 4, the faulted
   step timed to its return after a device sync. It reports the row's
   sentinel_step_ms_off / _on, sentinel_overhead_pct,
   sentinel_recovery_ms and sentinel_rollbacks (must be 1). At bs 8, with
   WarmupLR, the batch-size warmup and progressive layer drop on: (b) a
   quarantined NaN step launches 12 flash forward, 12 dk/dv and 12 dq
   (tensor-core) and no Adam, leaves masters, moments and compute
   parameters bit-equal and no schedule moved, its record reads
   ["nonfinite_grad"], the next step launches Adam once; (c) a run rolled
   back over a NaN step ends bit-identical to a clean run that never saw
   that batch (masters, moments, schedules, loss scale, counters); (d)
   under warn the NaN step reaches the masters through the Adam kernel,
   equal to its plain version on the same inputs; (e) a x1e4 loss spike
   is one "loss_spike" anomaly, clear on the next step; (f) abort_after 2
   raises TrainingHealthError on the second NaN step; (g) a 1.0 s hang
   deadline: a 2.5 s stall on the engine's first step (which builds the
   kernels under --sentinel-only) does not fire, one at serial 3 fires
   once with every thread's stack, and with save_on_preemption the fire
   makes the next step boundary write a checkpoint that `latest` names
   and raise SystemExit. Every run counts its launches exactly; with
   --profile, (a) also profiles 3 steps of each of its three engines;
30. sentinel parity, fp32: phase 29's model at 4 layers (micro 2 x gas
   2, clipping) under one fault plan (a x1e4 loss spike, NaN gradients
   twice in a row, one rollback) through the kernels and through the
   plain path: identical verdicts, counters and quarantine records,
   losses within rtol 1e-4; the legacy forward / backward / step loop on
   the same plan gives the verdicts of its gradient flags.
31. fp16 training: (a) train-fp16-125M, phase 7's model, batch and
   config with GPT-NeoX configs/125M.yml's fp16 block from 2^32: the
   opening overflows skipped (no Adam launch), then 14 steps taken on
   the classic fp16 Adam variant, the loss scale equal to a host replay
   of the JAX `update_loss_scale` rule over the observed overflow flags,
   the loss falling over the taken steps, every flash launch on the
   tensor cores, step ms, tokens/s and MFU beside phase 7's bf16; (b)
   train-moe-125M in fp16 (8 steps from 2^16, every grouped launch on
   wgmma); (c) train-bert-large-512-fp16-lamb, phase 15's BERT-large in
   fp16 with "Lamb" (bing_bert's options, 6 steps from 2^16); (e) the
   lean fp16 state (fp16 masters and moments, 8 steps from 2^16); (f)
   3 fp16 steps of the legacy loop equal to `train_batch`'s; (d)
   parity: 125M widths at 4 layers, fp16 kernels vs the plain path, the
   same overflow flags and scales, losses within rtol 2e-2;
32. serve-fp16-125M: phase 4's stream with fp16 weights and fp16 pools
   (every prefill on the tensor cores, every decode on the cluster
   kernel), then greedy tokens kernels vs plain: every first token
   identical, the identical requests counted.
33. train-sparse-125M-16k-fp16: phase 13's model, batch and JSON with
   GPT-NeoX configs/125M.yml's fp16 block from 2^16, 10 steps without
   and 10 with the bench row's "full" remat: every block-sparse launch
   "mma" (12 / 24 forward, 12 dk/dv, 12 dq a step), no flash launch,
   one Adam a taken step, the loss scale equal to a host replay of the
   JAX `update_loss_scale` over the observed overflows, the loss
   falling over the taken steps;
34. serve-quant-125M-fp16: row_quant's stream with fp16 weights at the
   int8w and int8w_int8kv rungs (exact launches, every int8 matmul
   "wgmma", every int8 decode "cluster"), then greedy tokens of 8
   prompts with int8 weights and pages through the kernels and the
   plain path: every first token identical;
35. a client module with a TiledLinear(768, 50304) head in 2 x 8 tiles
   through `initialize()` → `train_batch`, 5 steps in bf16 and in fp16
   beside the dense nn.Linear holding the same weights (losses within
   1e-2), then one bf16 step through a client SGD with momentum (no
   Adam launch; masters, momentum and the compute copy by its rule).
36. train-fp8ffn-125M: phase 7's rung with "quantization": {"ffn":
   {"recipe": "fp8", "amax_history_len": 16}} (the delayed-scaling FFN;
   bench.py's row_quant has no FFN part, so the rung is this phase's
   own), 20 steps: step ms, tokens/s and MFU beside phase 7's, the amax
   history [12, 4, 16] fp32, finite, one slot a micro-step and advanced,
   the loss falling, exact launches (every flash launch tensor-core, one
   Adam a step); then an int8-recipe rung of 6 steps. (b) `_fake_quant`
   and `scale_from_history` on the card bit-equal to the CPU's (2^20
   values, bf16, fp16 and fp32, both recipes), then 125M widths at 4
   layers in fp32, 4 steps a recipe through the kernels and through the
   plain path: losses within rtol 1e-4, histories within rtol 2e-2. (c)
   At 4 layers: fp16 from 2^32 with the fp8 FFN (every overflow step
   launches no Adam and keeps the history, the opening ones at zeros;
   each taken step one Adam and its slots), and a save after 3 bf16
   steps whose resume takes the next step bit-identical to the
   uninterrupted run (loss and history);
37. train-moe-125M-int8ffn: phase 11's rung with the int8 FFN, 10 steps,
   step ms beside phase 11's, every grouped forward, dx and dW launch on
   the wgmma design, the history held as in 36;
38. serve-gpt2xl-int8: the int8 matmul at GPT-2 XL's block shapes
   ((1600, 4800), (1600, 1600), (1600, 6400), (6400, 1600)) against its
   plain version at 16 and 256 bf16 rows (timed beside the plain version,
   torch.matmul on the dequantized weight and the bound) and 16 fp32
   rows; GPT-2 XL (seeded bf16 weights) serves row_quant's stream (16
   requests x 62 prompt tokens x 48 new, page 64) at the bf16 and int8w
   rungs (decode and stream tokens/s, inter-token p50; exact launches,
   every int8 matmul "wgmma"); greedy first tokens of 8 prompts with
   int8 weights equal through the kernels and the plain path; an fp32
   parity at XL widths and 2 layers token-identical to the plain path;
39. observability (train-telemetry-125M, serve-telemetry-125M; with
   ``--observability-only`` beside phase 7): (a) bench.py row_telemetry's
   rungs, phase 7's model behind the row's JSON (bf16, ZeRO-2, gas 1) at
   micro 16 and 8 with tensorboard on, 3 warm-up and 8 timed steps with
   the "telemetry" block off and then on (capture off): the step ms and
   the overhead against the 1% bar (printed, not gated), the same
   synchronizing CUDA calls in 3 steps after a monitor flush
   (`torch.cuda.set_sync_debug_mode`), the same flash, Adam and cuBLAS
   launches in a profiled step, the counted flops equal to the count
   from the shapes, the in-engine MFU equal within 2% to the counted
   flops over the step windows the script stamps itself, and its ratio
   to the analytic MFU beside the ratio the shapes fix (the prediction,
   printed with the host time outside the windows, not gated), the
   goodput fraction; (b) a capture window
   of 2 steps whose torch.profiler trace holds the spans and the flash
   and Adam kernels launched inside train_dispatch, then 2 NaN-gradient
   steps under policy "warn": one memory snapshot and one armed window;
   (c) phase 4's stream with telemetry and a monitor serving Prometheus
   on 127.0.0.1: the spans schedule / prefill / decode, the Serve/*
   scalars, the scrape's TTFT and inter-token histograms, `drain`
   flushing and closing the monitor, phase 4's first tokens; beside it
   the stream through an engine without telemetry and one with it in 4
   alternating rounds (the same tokens each round; the median tokens/s,
   the host µs of the Serve/* scalars a step and of one span); (d) phase
   11's MoE rung with moe.observability, 6 steps: the four Train/MoE/*
   scalars at every step, min <= 1/E <= max, the drop in [0, 1); (e)
   `python -m deeperspeed_tpu_torch.env_report --json` (every kernel
   available) and `dispatch_report()` ("mma", "cluster", "wgmma"); (f)
   phase 13's engine (2 x 16,384 tokens, block-sparse) with the
   telemetry block, beside it without, one step each: the counted flops
   equal to the shapes' count, exact launches, and the peak of allocated
   memory no more than 256 MiB above the telemetry-off engine's;
40. online RL (``--rl-only`` runs it alone, after phase 3's checks of the
   flash, Adam, paged-decode and int8 matmul kernels): first the bf16
   kernels of the rungs against their plain versions at the RL path's
   own shapes (heads 12 and 25, D 64: the flash forward and backward at
   [16, 128], the prefill at 64 tokens for 1 and 16 prompts, the paged
   decode at pages of 16, 8 a row, over bf16 and int8 pools), each on
   the tensor-core or cluster design; (f) a plain LM
   step over [16, 128] tokens on phase 7's config timed before the RL
   pair exists; (a) rl-ppo-125M: phase 7's model behind `RLDriver`
   (PPO-clip, 16 rollouts in groups of 4 from a seeded pool of 16
   prompts of 64 ids, 64 new tokens, sequence length 128; serving pages
   of 16, decode buckets up to 16, temperature 1.0, seed 7), 1 warm-up
   and 4 timed iterations: per iteration the loss, mean reward, mean KL,
   rollout tokens/s, the update's ms, swap_ms and compile_delta (0 on
   every timed iteration), exact launches (flash forward, backward,
   paged decode, Adam; every flash launch on the tensor-core design,
   every decode on the cluster kernel), finite losses, the frozen
   reference bit-equal to iteration 0's weights after the last update,
   the serving weights equal to the pre-update weights until each swap
   and to the trainer's after it; then (f) the same LM step with the
   pair resident: the co-residency tax beside the JAX bar of 10% (a
   finding); (b) the same with int8 weights and int8 KV pages on the
   serving side, 2 timed iterations (the int8 matmul on wgmma, the int8
   decode on the cluster kernel), swap_ms beside (a)'s; (c) DPO (group 4,
   8 update rows), 2 timed iterations, the first loss ln 2 within 1e-2;
   (d) kill and replay: `tests/torch_rl_worker.py` runs (a)'s loop at 2
   layers with 8 rollouts of 32 new tokens and a checkpoint every
   iteration in two
   children side by side, one uninterrupted and one killed (`os._exit`
   in the reward function) in iteration 2, then a third resumes the
   killed one: the losses and sampled tokens of iterations 1-3 equal bit
   for bit; (e) rl-ppo-gpt2xl: GPT-2 XL on the lean bf16 state with its
   server and its frozen reference co-resident, (a)'s block, 1 warm-up
   and 2 timed iterations, the pair's peak allocated memory, swap_ms and
   compile_delta 0; (g) parity: (a)'s model at 4 layers in fp32, greedy,
   group size 1, 2 iterations through the kernels and through the plain
   path: the same rollouts, losses within 1e-4, the mean KL within 1e-2
   and of the same sign.
41. data parallel and ZeRO 0-2 through a process group (``--dp-only``
   runs it alone, after phase 3's flash and Adam checks at the training
   shape): (a) phase 7's model and config (bf16, micro 16, S 1024,
   gas 2), 10 steps on one engine without a process group, then
   `init_distributed(dist_backend="nccl")` at world 1 and 10 steps at
   ZeRO 0, 1 and 2 each: losses and fp32 masters bit-equal to the
   engine without a group (at world 1 every collective is a copy), the
   step's ms beside the engine without a group (and phase 7's in the
   all-phase run), the CUDA-event ms of the step's collectives (the
   all-reduce, the reduce-scatter and the all-gather), exact launches
   of the flash forward, backward and Adam; (b) a rank's state bytes by
   the partition formula from the engine's buffers against
   `torch.cuda.memory_allocated` after the engine is built, and the
   formula's bytes a rank at worlds 2, 4 and 8 (arithmetic); (c) the
   flat Adam kernel on every partition of the world-2, -4 and -8
   layouts at the model's 162,322,944 parameters and on a partition
   whose start is not 16-byte aligned (the kernel's one-element path):
   each partition equal to the plain version on its slice, the
   partitions together bit-equal to the whole-buffer step; (d) two
   ranks over gloo on this one card (`tests/torch_dp_worker.py`
   children, micro 8 each, so the global batch is (a)'s), ZeRO 1 and 2,
   5 steps: losses within rtol 2e-2 of (a)'s (bf16 products at micro 8
   round apart from micro 16), the ranks' losses equal;
42. ZeRO stage 3, train-zero3-125M (``--zero3-only`` runs it alone,
   after phase 3's flash and Adam checks at the training shape): (a)
   phase 7's model and config, 10 steps on one engine without a process
   group, then at world 1 over NCCL stage 3 "gspmd" and "explicit"
   (prefetch 2, buckets of 32 MB, groups of 4 layers, remat on and off):
   losses and fp32 masters (gathered, natural order) bit-equal to the
   engine without a group, the step's ms, each collective's median
   CUDA-event ms by row (all-gather a row, reduce-scatter a row's
   gradient), exact launches of the flash forward (twice a layer under
   remat), backward and Adam; (b) a rank's bytes at rest, 18 a
   partition element and 2 a persisted one, from the buffers and
   against `torch.cuda.memory_allocated` after the build (32 MiB), and
   `max_memory_allocated` over a step; (c) bench.py row_zero3's
   quantities at world 1 (seq 1024, the first batch of 48, 32 that
   fits, gas 1, 6 steps after 2): tokens/s and MFU at stage 0, stage 3
   "gspmd" and "explicit" without remat, printed, not gated; (d) two
   gloo ranks on this card (micro 8 each), "gspmd" and "explicit", 3
   steps each: losses within rtol 2e-2 of (a)'s, the ranks' losses
   equal, each rank's bytes at rest the formula at world 2;
43. MoE across ranks, train-moe-ep-125M (``--moe-ep-only`` runs it
   alone, after phase 3's flash, Adam and grouped-matmul checks and
   phase 11): (a) phase 11's model and JSON at ZeRO stage 0, 10 steps
   on one engine without a process group, then at world 1 over NCCL on
   a 1-D "expert" `DeviceMesh` (the route over the group, the exchange
   by all-to-alls, a copy at world 1): losses and fp32 masters bit-equal
   to the engine without a group, exact launches (24 grouped forward,
   24 dx and 24 dW a step, all "wgmma"; flash; one Adam), the step's
   ms beside phase 11's, and each all-to-all shape of that run timed
   on the device (CUDA events behind a spin kernel that hides the
   host's enqueue, `a2a_device_ms`) with the host's enqueue beside; (b) `moe_ffn_expert_parallel` at ep 1
   against `moe_ffn_dense` at phase 11's layer geometry in bf16, both
   engines, the sort engine's exchange in 1 and 2 chunks: y and the aux
   loss bit-equal (the gradients' identity printed); (c) two gloo ranks
   on this card (micro 4 each, so the global batch is (a)'s), 3 steps
   on the "expert" mesh (4 experts a rank) and 3 on the data-parallel
   path with replicated experts routing the global micro-batch
   (capacity factor 1.25, aux loss coefficient 0.01): losses within
   rtol 1e-3 of (a)'s, the fp32 masters' gap to (a)'s after 3 steps
   below 0.5 of (a)'s update, experts and dense apart (`master_gap`),
   the ranks' losses equal, the collectives that went through the host
   (gloo takes CPU tensors) counted; (d) the grouped
   matmul on an owner's received buffer at ep 2 (4 experts of 2 ragged
   spans, an empty expert): forward, dx and dW against the plain
   version, two calls bit-identical, the forward timed;
Phase 3 also holds every fp16 variant against its plain version in fp16
(flash forward and backward at the training shape, at D 128, on ragged
segments and at BERT's key-bias + dropout shape with its all-masked
row; an overflow case whose non-finite dq, dk, dv must sit where the
plain version's do; the cluster decode over fp16 pools and over int8
pools with fp16 q; grouped forward, dx and dW; Adam classic and lean at
125M's size; the block-sparse forward, dk/dv and dq at phase 13's shape
and at D 128, with their own overflow case; the int8 matmul with fp16
activations at M = 16, 256 and 4096, its widening read out bit for bit
and an fp16 overflow to inf), each timed beside its plain version, a
library call and its bound, with two-call identity and the launches by
design.
Phase 3 also holds the flat Adam kernel at GPT-2 XL's size in the lean
(bf16 p, g, m, v) and the classic (fp32 p, m, v, bf16 g and copy)
dtypes against its plain version chunk by chunk, two calls
bit-identical, timed beside `torch.optim.AdamW(fused=True)`.

It prints its wall seconds, one JSON line of kernel results, then the
card line, then as the last line ``{"ok": true, "device": {...}}``. A
longer report goes to build/reports/chip_smoke_report.json. It imports
nothing of JAX.
"""

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerances of the kernel checks. bf16: the kernel rounds its output to
# bf16 once, the plain version rounds the probabilities before P·V, so
# outputs differ by a few bf16 ulps; the lse is fp32 from the same bf16
# products in both. fp32: only the summation order differs.
TOL = {torch.bfloat16: {"out": (2e-2, 2e-2), "lse": (1e-3, 0.0)},
       torch.float32: {"out": (1e-4, 1e-4), "lse": (1e-4, 1e-4)}}
# flash backward: dq, dk, dv. bf16: inputs and outputs round to bf16 and
# the kernel sums P·dO and dS·Q from fp32 tiles of them while the plain
# version rounds nothing in between; fp32: only the summation order
# differs.
TOL_BWD = {torch.bfloat16: (3e-2, 3e-2), torch.float32: (1e-4, 1e-4)}
# flat Adam: p, m, v in fp32 differ by a rounding or two (the kernel
# fuses multiply-adds); its bf16 copy must be exactly its own new p
# rounded to bf16 (the recast written in the same pass)
TOL_ADAM = (1e-6, 1e-6)
# weight-only int8 matmul, as a fraction of max|ref|: bf16 rounds its
# output once and sums in another order than the plain version; fp32
# differs only in the summation order
TOL_QMM = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-5}
# the (K, N) of GPT-NeoX-125M's four block matmuls (qkv, out-proj,
# mlp-in, mlp-out), checked at the rows phase 9 gives them: a decode step
# of 16 sequences and a prefill call of 4 x 64 tokens
QMM_BLOCK_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
QMM_PATH_ROWS = (16, 256)
# the (K, N) also checked at serve-125M's largest bucket (M = 4096) and
# timed at every M: mlp-in and mlp-out
QMM_SHAPES = ((768, 3072), (3072, 768))
# weight bytes cycled through when timing, above the 50 MB L2, so each
# launch reads its weight from device memory as a decode step does
QMM_COLD_BYTES = 64 << 20
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 989e12

# serve-quant-125M: the decode-heavy stream of bench.py's row_quant
# (bench.py:2072-2124) at its three rungs
QUANT_SERVE_CONFIG = {"inference": {
    "enabled": True, "page_size": 64, "num_pages": 257,
    "max_batch_size": 16, "token_budget": 2048, "prefill_lengths": [64],
    "prefill_batch_sizes": [4], "decode_batch_sizes": [16]}}
QUANT_RUNGS = (("bf16", None, None), ("int8w", "int8", None),
               ("int8w_int8kv", "int8", "int8"))
QUANT_REQUESTS, QUANT_PROMPT, QUANT_NEW = 16, 62, 48
# the lengths of serve-quant's decode window (62-token prompts, up to 48
# new tokens): paged decode's second timed shape
DECODE_SERVE_LENGTHS = (QUANT_PROMPT, QUANT_PROMPT + QUANT_NEW)
SERVE_CONFIG = {"inference": {
    "enabled": True, "page_size": 64, "num_pages": 513,
    "max_batch_size": 16, "token_budget": 2048,
    "prefill_batch_sizes": [4], "decode_batch_sizes": [16]}}
NEOX_125M = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024)
# train-125M: the DeepSpeed config of bench.py's _neox_engine with the
# training knobs the main path reads; gas 2 puts the fp32 accumulation
# across micro-batches on the path
TRAIN_CONFIG = {
    "train_batch_size": 32, "train_micro_batch_size_per_gpu": 16,
    "gradient_accumulation_steps": 2, "steps_per_print": 1000,
    "optimizer": {"type": "Adam", "params": {
        "lr": 6e-4, "betas": [0.9, 0.95], "eps": 1e-8,
        "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0, "warmup_max_lr": 6e-4, "warmup_num_steps": 5}},
    "gradient_clipping": 1.0,
    "fp16": {"enabled": True, "type": "bfloat16"},
    "zero_optimization": {"stage": 2},
}
TRAIN_STEPS = 20
TRAIN_SEQ = 1024
# train-moe-125M: bench.py's row_moe on one card, a dense GPT-NeoX-125M
# made MoE by the JSON "moe" block alone
MOE_BLOCK = {"num_experts": 8, "top_k": 2, "capacity_factor": 1.25,
             "dispatch": "sort"}
MOE_TRAIN_CONFIG = {**TRAIN_CONFIG, "train_batch_size": 8,
                    "train_micro_batch_size_per_gpu": 8,
                    "gradient_accumulation_steps": 1, "moe": MOE_BLOCK}
MOE_NUM_PARAMS = 559_080_960
# the grouped matmul at phase 11's geometry: 8 experts, span 2560 (the
# capacity int(1.25 * 2 * 8192 / 8)), 16,384 live rows (8192 tokens x 2
# copies) in ragged sizes with an empty expert, full spans and a size no
# tile divides; the two FFN products
GMM_SPAN = 2560
GMM_SIZES = (2560, 1801, 0, 2560, 2400, 2367, 2560, 2136)
GMM_SHAPES = ((768, 3072), (3072, 768))
# a small case whose weights own several spans, one weight with no live
# row, a span and an N that no tile divides
GMM_LUT_CASE = dict(sizes=(200, 57, 0, 0, 133, 200), span=200, K=64, N=96,
                    W=3, lut=(0, 0, 1, 1, 2, 2))
# grouped matmul tolerances as a fraction of max|ref|: bf16 outputs (y,
# dx) round once after an fp32 sum in another order than the plain
# version; fp32 outputs and the fp32 dW differ only in the order
TOL_GMM = {torch.bfloat16: 1e-2, torch.float16: 5e-3, torch.float32: 1e-5}
TOL_GMM_DW = 1e-4
TRAIN_VOCAB_USED = 512    # ids drawn from [0, 512), so the loss must fall
# train-sparse-125M-16k: bench.py's row_longseq sparse rung on one card
# (bench.py:696-737), the _neox_engine JSON (bench.py:204-220) with the
# fixed pattern of 16 local and 1 global 128-blocks a window, causal
SPARSE_L16G1 = {"mode": "fixed", "block": 128, "num_local_blocks": 16,
                "num_global_blocks": 1, "attention": "unidirectional"}
SPARSE_L4G1 = dict(SPARSE_L16G1, num_local_blocks=4)
SPARSE_MODEL = dict(vocab_size=8192, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=16384)
SPARSE_TRAIN_CONFIG = {
    "train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 1, "steps_per_print": 10_000,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
    "fp16": {"enabled": True, "type": "bfloat16"},
    "zero_optimization": {"stage": 2},
    "sparse_attention": SPARSE_L16G1,
}
SPARSE_SEQ = 16384
SPARSE_STEPS = 10
# train-bert-large-512: bench.py's row_bert512 on one card (bench.py:520,
# _bert_row :463-516): BERT-large at full width and depth, Adam lr 1e-4,
# bf16, ZeRO-2, micro 20 x gas 1 at 512 tokens, dropout 0.1, an all-ones
# mask (a zero key bias), 15% MLM labels
BERT_SEQ = 512
BERT_MICRO = 20
BERT_STEPS = 10
BERT_NUM_PARAMS = 336_232_258
BERT_TRAIN_CONFIG = {
    "train_batch_size": BERT_MICRO,
    "steps_per_print": 10_000,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
    "fp16": {"enabled": True, "type": "bfloat16"},
    "zero_optimization": {"stage": 2},
}
BERT_DROPOUT_SEED = 123457
# the flash kernels' key-bias / dropout flags against their plain
# versions: bf16 as the flash checks above; fp32 differs only in the
# summation order, and one flipped keep bit moves an output by about
# p / (1 - rate), some 1e-3 at S = 512, so 1e-5 catches it
TOL_FLAGS = {torch.bfloat16: {"out": (2e-2, 2e-2), "bwd": (3e-2, 3e-2)},
             torch.float32: {"out": (1e-5, 1e-5), "bwd": (1e-5, 1e-5)}}
# train-125M-ckpt: phase 7's run saved after 6 steps and resumed for 4
CKPT_STEPS_BEFORE = 6
CKPT_STEPS_AFTER = 4
# train-packed-125M-16k: bench.py's row_packed on one card (bench.py:771-
# 846): phase 13's model (125M widths and depth, vocabulary 8192) at
# 16,384 tokens, the _neox_engine JSON with the "packing" block and the
# row's remat_blocks=True ("full"), on the first 2 rows of its seeded
# lognormal document mixture (mean 2048 tokens, sigma 1.2)
PACKED_SEQ = 16384
PACKED_DOCS = dict(seed=7, n_docs=64, vocab_size=8192, mean_len=2048.0,
                   sigma=1.2)
PACKED_TRAIN_CONFIG = {
    **{k: v for k, v in SPARSE_TRAIN_CONFIG.items()
       if k != "sparse_attention"},
    "packing": {"enabled": True},
    "activation_checkpointing": {"policy": "full"},
}
PACKED_STEPS = 10
# the no-remat run and the other policies beside the main run
PACKED_POLICY_STEPS = 3
# phase 19: (a) phase 18's model at 4 layers and S 4096; (b) BERT-large's
# widths at 4 layers, S 512, packed rows, two remat spans
PACKED_PARITY_SEQ = 4096
BERT_PACKED_SEQ = 512
# the long report, under the git-ignored build directory
REPORT_DIR = os.path.join("build", "reports")

# GPT-2 XL (bench.py row_gpt2xl; Megatron GPT-2 1.5B): the config, its
# parameter count, the row's flops a token (6N + 12·L·h·S, bench.py:612)
GPT2_XL = dict(vocab_size=50304, hidden_size=1600, num_layers=48,
               num_heads=25, max_seq_len=1024)
GPT2_XL_PARAMS = 1_557_686_400
GPT2_SEQ = 1024
GPT2_FTOK = 6 * GPT2_XL_PARAMS + 12 * 48 * 1600 * GPT2_SEQ
GPT2_WARMUP, GPT2_STEPS = 2, 3
# the kernels a GPT-2 XL training step launches
GPT2_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "adam")
# phase 20's rungs: (tag, micro batch, remat policy (None: whole-block
# remat), lean state)
GPT2_RUNGS = (("onchip_dots_bs8", 8, "dots", True),
              ("onchip_attn_residuals_bs8", 8, "attn_residuals", True),
              ("onchip_full_bs8", 8, "full", True),
              ("onchip_lean_bs4", 4, None, True),
              ("classic_full_bs8", 8, "full", False))
# phase 3's Adam at GPT-2 XL's size: hyperparameters, and the chunk the
# plain version runs over (its fp32 temporaries stay near 5 GB)
ADAM_XL_HP = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
ADAM_XL_CHUNK = 1 << 27

# serve-prefix-125M / serve-gpt2xl-spec: bench.py's row_serve_prefix
# (bench.py:1529-1660): the row's "inference" block, its stream (32
# requests, one shared 256-token prefix, every fifth prompt cold, tails
# of 8-48 tokens, 32 new tokens) and its speculative depth
PREFIX_BLOCK = {"enabled": True, "page_size": 64, "num_pages": 513,
                "max_batch_size": 8, "token_budget": 2048,
                "prefill_batch_sizes": [4], "decode_batch_sizes": [8]}
PREFIX_REQUESTS, PREFIX_LEN, PREFIX_NEW, PREFIX_SPEC_K = 32, 256, 32, 4
# the row's draft for GPT-NeoX-125M (bench.py:1551-1553): head dim 32,
# which the paged-decode dispatch sends to the plain version
PREFIX_DRAFT = dict(vocab_size=50304, hidden_size=256, num_layers=4,
                    num_heads=8, max_seq_len=1024)

# serve-chaos-125M: bench.py's row_serve_chaos (bench.py:1388-1526): the
# row's "inference" block (robustness layer on), its stream (64 requests,
# lognormal(5.0, 0.8) prompt lengths, 64 new tokens, one submission every
# 2 steps) and its fault storm (step serials count the warm-up's steps)
CHAOS_BLOCK = {"enabled": True, "page_size": 64, "num_pages": 513,
               "max_batch_size": 16, "token_budget": 2048,
               "prefill_batch_sizes": [4], "decode_batch_sizes": [16],
               "admission": {"max_queue_depth": 24},
               "retry": {"max_attempts": 3, "backoff_base_ms": 5,
                         "backoff_cap_ms": 50, "jitter": 0.25}}
CHAOS_REQUESTS, CHAOS_NEW = 64, 64
CHAOS_STORM = [
    {"kind": "decode_error", "step": 40, "times": 2},
    {"kind": "decode_error", "step": 120, "times": 1},
    {"kind": "decode_stall", "step": 80, "seconds": 0.05},
    {"kind": "page_pool_pressure", "step": 60, "times": 5, "factor": 0.7},
]
# phase 27(b): the hang watchdog's timeout, the stall that trips it (at a
# step serial past the warm-up, inside the decode phase of 16 requests)
# and the cold engine's timeout, below any step's time
CHAOS_HANG_TIMEOUT_S, CHAOS_STALL_S, CHAOS_STALL_STEP = 0.25, 1.0, 20
CHAOS_HANG_REQUESTS, CHAOS_COLD_TIMEOUT_S = 16, 0.001
# phase 28: transient faults over the two waves of a shared-prefix stream
# (misses, then hits)
CHAOS_PARITY_FAULTS = [
    {"kind": "prefill_error", "step": 1},
    {"kind": "decode_error", "step": 4},
    {"kind": "page_pool_pressure", "step": 6, "times": 2, "factor": 0.7},
    {"kind": "decode_error", "step": 25},
]

# train-sentinel-125M: bench.py's row_sentinel (bench.py:972-1059) on one
# card, not cut: GPT-NeoX-125M with the row's JSON (Adam lr 1e-4, bf16,
# ZeRO-2, gas 1, S 1024) at bs 16 and 8, 3 warm-up and 8 timed steps with
# the sentinel off and on, then the rollback recovery
SENTINEL_BASE = {
    "gradient_accumulation_steps": 1, "steps_per_print": 10_000,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
    "fp16": {"enabled": True, "type": "bfloat16"},
    "zero_optimization": {"stage": 2},
}
SENTINEL_RUNGS = (16, 8)
SENTINEL_WARMUP, SENTINEL_STEPS = 3, 8
# the off / on / eager-probe engines' alternating rounds of 8 steps
SENTINEL_ROUNDS = 10
# the third engine of the rounds: the probe without its host read
SENTINEL_WARN = {"enabled": True, "policy": "warn", "warmup_steps": 3}
SENTINEL_ON = {"enabled": True, "policy": "skip_batch", "warmup_steps": 3}
SENTINEL_ROLLBACK = {"enabled": True, "policy": "rollback",
                     "rollback_after": 1, "warmup_steps": 100,
                     "fault_injection": {"faults": [
                         {"kind": "nan_grads", "step": 4}]}}
# phase 29(b)-(g) at bs 8, with the step boundary's schedules on
SENTINEL_MICRO = 8
SENTINEL_SCHEDULES = {
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0, "warmup_max_lr": 1e-4,
        "warmup_num_steps": 10}},
    "batch_size_schedule": {"enabled": True, "params": {
        "min_batch_size_multiplier": 0.25, "warmup_num_steps": 6,
        "num_intervals": 4}},
    "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                               "gamma": 0.05},
}
# 29(g): the watchdog's deadline (about 10x a bs-8 step) and the stall
# that trips it
SENTINEL_HANG_S, SENTINEL_STALL_S = 1.0, 2.5
# phase 30: 125M widths at 4 layers in fp32, micro 2 x gas 2, clipping;
# one plan: a loss spike (quarantined), then NaN gradients twice in a
# row (quarantined, then rolled back to the save before them)
SENTINEL_PARITY_LAYERS = 4
SENTINEL_PARITY_STEPS, SENTINEL_PARITY_SAVE = 10, 6
SENTINEL_PARITY_TH = {
    "enabled": True, "policy": "rollback", "rollback_after": 2,
    "warmup_steps": 3, "fault_injection": {"faults": [
        {"kind": "loss_spike", "step": 4, "factor": 1e4},
        {"kind": "nan_grads", "step": 7, "times": 2}]}}


def fail(msg):
    # on both streams: a caller that keeps only the end of one still
    # sees why the run failed
    print(f"chip_smoke FAILED: {msg}", flush=True)
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup=5, iters=25):
    """Median milliseconds of ``fn()`` over ``iters`` runs, each between
    two CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, launches=20, replays=5):
    """Device milliseconds of one call of ``fn`` without the host's launch
    overhead: ``launches`` calls captured in one CUDA graph, the graph
    replayed ``replays`` times between two CUDA events. For the kernels
    of a decode step (tens of microseconds), where one call timed
    between events mostly measures the Python wrapper and the launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return float(ms)


def kernel_name(mangled):
    """A kernel's name from its mangled symbol, with its template
    arguments spelled out: flash_fwd_mma_kernel<64, false, true>."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    i, name = 0, mangled
    while i < len(s) and s[i].isdigit():      # length-prefixed components
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        name, i = s[j:j + n], j + n
    args = []
    if i < len(s) and s[i] == "I":
        i += 1
        while i < len(s) and s[i] != "E":
            if s.startswith("13__nv_bfloat16", i):
                args.append("bf16")
                i += len("13__nv_bfloat16")
            elif s.startswith("6__half", i):
                args.append("fp16")
                i += len("6__half")
            elif s[i] == "f":
                args.append("float")
                i += 1
            elif s[i] == "L":                 # literal: L<type><value>E
                j = s.index("E", i)
                kind, value = s[i + 1], s[i + 2:j]
                args.append({"0": "false", "1": "true"}[value] if kind == "b"
                            else value)
                i = j + 1
            else:
                break
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_summary(log):
    """One row per compiled kernel of nvcc's ``-Xptxas -v`` report: its
    source, name (template arguments spelled out), registers a thread,
    named barriers, static shared memory bytes (dynamic shared memory,
    which the wgmma and mma.sync kernels take, is set at launch) and
    spill stores and loads in bytes."""
    rows, src, cur = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"source": src, "kernel": kernel_name(m.group(1)),
                   "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            b = re.search(r"used (\d+) barriers", line)
            sm = re.search(r"(\d+) bytes smem", line)
            cur["barriers"] = int(b.group(1)) if b else 0
            cur["static_smem"] = int(sm.group(1)) if sm else 0
            rows.append(cur)
            cur = None
    return rows


def close(got, want, atol, rtol):
    """(max abs error, ok) of got vs want under |g - w| <= atol + rtol|w|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all()) and \
        bool(torch.isfinite(g).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def prefill_case(S, dtype, gen, B=4, H=12, D=64):
    """q, k, v as the main path hands them over (views split out of one
    [B, S, H, 3D] projection) and ragged segment ids: a real-token prefix
    of random length, pad tail (one row full)."""
    qkv = torch.randn(B, S, H, 3 * D, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.split(D, dim=-1)
    lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    seg = (torch.arange(S, device="cuda")[None] < lens[:, None]).to(
        torch.int32)
    return q, k, v, seg, lens


def bound_ms(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def live_pairs(seg, B, S):
    """Live (causal, same-segment) (row, key) pairs of this run's inputs:
    an id held by c tokens of a row gives c(c+1)/2 of them."""
    if seg is None:
        return B * S * (S + 1) // 2
    pairs = 0
    for row in seg.cpu().numpy():
        _, counts = np.unique(row, return_counts=True)
        pairs += int((counts * (counts + 1) // 2).sum())
    return pairs


def prefill_bound_ms(q, seg):
    B, S, H, D = q.shape
    esize = q.element_size()
    seg_bytes = B * S * 4 if seg is not None else 0
    nbytes = 4 * B * S * H * D * esize + seg_bytes + B * H * S * 4
    return bound_ms(nbytes, 4 * H * D * live_pairs(seg, B, S))


def check_prefill(fa, gen, report):
    import torch.nn.functional as F
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (64, 256, 1024):
            q, k, v, seg, _ = prefill_case(S, dtype, gen)
            out, lse = fa.flash_attention_cuda(q, k, v, seg)
            ref_out, ref_lse = fa.flash_attention_segmented_reference(
                q, k, v, seg)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err_o, ok_o = close(out, ref_out, *tol["out"])
            err_l, ok_l = close(lse, ref_lse, *tol["lse"])
            # a segmented tile skip must not change a plain causal call
            out_c, _ = fa.flash_attention_cuda(q, k, v, None)
            ref_c, _ = fa.flash_attention_segmented_reference(q, k, v, None)
            err_c, ok_c = close(out_c, ref_c, *tol["out"])
            row = {"S": S, "dtype": str(dtype), "max_abs_err_out": err_o,
                   "max_abs_err_lse": err_l, "max_abs_err_causal": err_c,
                   "tol_out": tol["out"], "tol_lse": tol["lse"]}
            print(f"  flash_fwd {row}", flush=True)
            if not (ok_o and ok_l and ok_c):
                fail(f"flash prefill kernel disagrees with its plain "
                     f"version: {row}")
            if dtype == torch.bfloat16:
                mask = torch.ones(S, S, dtype=torch.bool, device="cuda")
                mask = mask.tril()[None] & (seg[:, :, None] ==
                                            seg[:, None, :])
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                mask4 = mask[:, None]
                row["ms"] = time_ms(lambda: fa.flash_attention_cuda(
                    q, k, v, seg))
                row["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_segmented_reference(
                        q, k, v, seg))
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask4))
                row["bound_ms"], row["bound_by"] = prefill_bound_ms(q, seg)
                print(f"  flash_fwd times S={S}: kernel {row['ms']:.4f} ms, "
                      f"plain {row['plain_ms']:.4f} ms, library "
                      f"{row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.5f} ms ({row['bound_by']})",
                      flush=True)
            rows.append(row)
    # the other head dims the kernel is built for, and a length that is
    # no multiple of its 64-row tile
    for dtype in (torch.bfloat16, torch.float32):
        for S, B, H, D in ((100, 2, 3, 128), (200, 1, 2, 256)):
            q, k, v, seg, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
            out, lse = fa.flash_attention_cuda(q, k, v, seg)
            ref_out, ref_lse = fa.flash_attention_segmented_reference(
                q, k, v, seg)
            torch.cuda.synchronize()
            err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
            err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
            row = {"S": S, "B": B, "H": H, "D": D, "dtype": str(dtype),
                   "max_abs_err_out": err_o, "max_abs_err_lse": err_l}
            print(f"  flash_fwd {row}", flush=True)
            if not (ok_o and ok_l):
                fail(f"flash prefill kernel disagrees with its plain "
                     f"version: {row}")
            rows.append(row)
    report["flash_fwd"] = rows
    return next(r for r in rows
                if r["S"] == 1024 and r["dtype"] == str(torch.bfloat16))


def decode_query_case(dtype, gen, B, H, D, ps, NP, P, serving=False):
    """q as a strided view like the engine's, a random page permutation,
    trash page 0 past each length; lengths in [0, NP·ps] with 0 and exact
    page multiples, or (``serving``) drawn from serve-quant's decode
    window, `DECODE_SERVE_LENGTHS`."""
    qkv = torch.randn(B, H, 3 * D, generator=gen, device="cuda").to(dtype)
    q = qkv[..., :D]
    if serving:
        lo, hi = DECODE_SERVE_LENGTHS
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen,
                                device="cuda")
    else:
        lengths = torch.randint(0, NP * ps + 1, (B,), generator=gen,
                                device="cuda")
        edge = torch.tensor([0, ps, NP * ps, 3 * ps], device="cuda")[:B]
        lengths[:len(edge)] = edge
    perm = torch.randperm(P - 1, generator=gen, device="cuda")[:B * NP] + 1
    table = perm.reshape(B, NP)
    live = (torch.arange(NP, device="cuda")[None] * ps < lengths[:, None])
    table = torch.where(live, table, torch.zeros_like(table))
    return q, table.to(torch.int32), lengths.to(torch.int32)


def decode_pools(gen, L, P, H, ps, D, dtype, int8):
    """L layers' pools [L, P, H, ps, D] in ``dtype``, or int8 with bf16
    scale pools [L, P, H, ps] → (k, v) or (k, v, k_scales, v_scales)."""
    if not int8:
        return tuple(torch.randn(L, P, H, ps, D, generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
    kv = tuple(torch.randint(-127, 128, (L, P, H, ps, D), generator=gen,
                             device="cuda", dtype=torch.int8)
               for _ in range(2))
    return kv + tuple(
        (0.005 + 0.02 * torch.rand(L, P, H, ps, generator=gen,
                                   device="cuda")).to(torch.bfloat16)
        for _ in range(2))


def decode_call(da, q, views, table, lengths):
    """The wrapper a main path calls on one layer's views."""
    if len(views) == 4:
        return da.paged_decode_int8_cuda(q, *views, table, lengths)
    return da.paged_decode_cuda(q, *views, table, lengths)


def decode_reference(da, q, views, table, lengths):
    scales = dict(zip(("k_scales", "v_scales"), views[2:]))
    return da.paged_decode_attention_reference(q, views[0], views[1], table,
                                               lengths, **scales)


def decode_bound_ms(q, lengths, kv_bytes=None, scale_bytes=0):
    """Live K and V rows (and, for int8 pools, their bf16 scales) read
    once, q read and the output written once, the page table and
    lengths."""
    B, H, D = q.shape
    esize = q.element_size()
    kv_bytes = esize if kv_bytes is None else kv_bytes
    tokens = int(lengths.long().sum())
    nbytes = 2 * H * tokens * (D * kv_bytes + scale_bytes) + \
        2 * B * H * D * esize + 8 * B
    return bound_ms(nbytes, 4 * H * D * tokens)


def decode_times(da, gen, int8, serving, B=16, H=12, D=64, ps=64, NP=16,
                 P=513, dtype=torch.bfloat16):
    """One timed bf16 (or, with ``dtype``, fp16) shape: the kernel
    checked on it, then the kernel,
    the single-block kernel (the parent's, kept for fp32 pools and D
    256; through `launch_kernel` with cluster 0, where the module has
    it), the plain version and SDPA on pre-gathered K/V (dequantized for
    int8 pools), each timed cold and warm. Cold: the calls cycle through
    the views of L layers of pools, so many that between two uses of a
    layer the others read at least `QMM_COLD_BYTES` (at least 3, as a
    serving step walks its layers' distinct pools); SDPA cycles through
    L pre-gathered copies. Warm: 20 calls on one layer's view."""
    import torch.nn.functional as F
    q, table, lengths = decode_query_case(dtype, gen, B, H, D, ps, NP, P,
                                          serving)
    kv_bytes, scale_bytes = (1, 2) if int8 else (2, 0)
    live = 2 * H * int(lengths.long().sum()) * (D * kv_bytes + scale_bytes)
    L = max(3, 1 + -(-QMM_COLD_BYTES // live))
    pools = decode_pools(gen, L, P, H, ps, D, dtype, int8)
    views = [tuple(p[i] for p in pools) for i in range(L)]
    out = decode_call(da, q, views[0], table, lengths)
    again = decode_call(da, q, views[0], table, lengths)
    ref = decode_reference(da, q, views[0], table, lengths)
    torch.cuda.synchronize()
    tol = TOL_FP16["decode"] if dtype == torch.float16 else TOL[dtype]["out"]
    err, ok = close(out, ref, *tol)
    zero_ok = bool((out[lengths == 0] == 0).all())
    same = torch.equal(out, again)
    row = {"dtype": str(dtype), "int8_pools": int8,
           "shape": f"B={B} H={H} D={D} ps={ps} NP={NP} P={P}",
           "lengths_drawn": (f"{DECODE_SERVE_LENGTHS[0]}-"
                             f"{DECODE_SERVE_LENGTHS[1]}" if serving else
                             f"0-{NP * ps} with 0, {ps}, {NP * ps}, "
                             f"{3 * ps}"),
           "lengths": lengths.tolist(), "max_abs_err": err, "tol": tol,
           "two_calls_identical": same, "layers_cycled": L,
           "live_bytes": live}
    if not (ok and zero_ok and same):
        fail(f"paged decode kernel disagrees with its plain version at its "
             f"timed shape (zero rows exact: {zero_ok}, bit-identical: "
             f"{same}): {row}")
    NPg = -(-int(lengths.max()) // ps)
    pt = table[:, :NPg].long()

    def gathered(v):
        k, vv = v[0][pt], v[1][pt]
        if int8:
            k = (k.float() * v[2][pt].float()[..., None]).to(q.dtype)
            vv = (vv.float() * v[3][pt].float()[..., None]).to(q.dtype)
        return tuple(t.movedim(2, 1).reshape(B, H, NPg * ps, D)
                     for t in (k, vv))
    copies = [gathered(v) for v in views]
    mask = (torch.arange(NPg * ps, device="cuda")[None] <
            lengths[:, None])[:, None, None, :]
    q4 = q.contiguous()[:, :, None, :]
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]

    def kernel(v):
        return decode_call(da, q, v, table, lengths)

    def plain(v):
        return decode_reference(da, q, v, table, lengths)

    def library(g):
        return F.scaled_dot_product_attention(q4, *g, attn_mask=mask)
    n_plain = min(L, 4)   # each plain call writes [B, H, NP·ps, D] gathers
    row["ms"] = time_ms(lambda: kernel(nxt(views)))
    row["plain_ms"] = time_ms(lambda: plain(nxt(views[:n_plain])), warmup=2,
                              iters=10)
    row["library_ms"] = time_ms(lambda: library(nxt(copies)))
    row["bound_ms"], row["bound_by"] = decode_bound_ms(
        q, lengths, kv_bytes=kv_bytes, scale_bytes=scale_bytes)
    row["graph_ms"] = graph_ms(lambda: kernel(nxt(views)), launches=L)
    row["warm_graph_ms"] = graph_ms(lambda: kernel(views[0]))
    row["plain_graph_ms"] = graph_ms(lambda: plain(nxt(views[:n_plain])),
                                     launches=n_plain, replays=2)
    row["library_graph_ms"] = graph_ms(lambda: library(nxt(copies)),
                                       launches=L)
    row["library_warm_graph_ms"] = graph_ms(lambda: library(copies[0]))
    row["library"] = (f"SDPA on pre-gathered{', dequantized' if int8 else ''}"
                      f" {str(q.dtype)[6:]} K/V of {NPg * ps} positions, "
                      f"bool mask")
    if hasattr(da, "launch_kernel"):
        def fixed(cluster):
            return lambda v: da.launch_kernel(q, v[0], v[1], table, lengths,
                                              None, cluster, *v[2:])
        single = fixed(0)
        row["parent_max_abs_err"], _ = close(single(views[0]), ref, *tol)
        row["parent_graph_ms"] = graph_ms(lambda: single(nxt(views)),
                                          launches=L)
        row["parent_warm_graph_ms"] = graph_ms(lambda: single(views[0]))
        # the plan's cluster beside min(8, pages a row), the row alone's
        row["cluster"] = da.launch_plan(B, H, NP)
        row["cluster8_graph_ms"] = graph_ms(
            lambda: fixed(min(8, NP))(nxt(views)), launches=L)
    print(f"  {'paged_decode_int8' if int8 else 'paged_decode'} timed "
          f"({'serving lengths ' + row['lengths_drawn'] if serving else 'lengths 0-1024'}"
          f", {L} layers cycled): max abs err {err:.2e}; kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); in a CUDA graph, cold: kernel "
          f"{row['graph_ms']:.4f} ms (clusters of {row.get('cluster')}; of "
          f"{min(8, NP)}: {row.get('cluster8_graph_ms', float('nan')):.4f} "
          f"ms), parent "
          f"{row.get('parent_graph_ms', float('nan')):.4f} ms, plain "
          f"{row['plain_graph_ms']:.4f} ms, library "
          f"{row['library_graph_ms']:.4f} ms; warm: kernel "
          f"{row['warm_graph_ms']:.4f} ms, parent "
          f"{row.get('parent_warm_graph_ms', float('nan')):.4f} ms, library "
          f"{row['library_warm_graph_ms']:.4f} ms", flush=True)
    del pools, views, copies
    torch.cuda.empty_cache()
    return row


def check_decode(da, report, int8=False):
    """The bf16/fp32-pool (or, with ``int8``, the int8-pool) kernel against
    its plain version at the serving shape (B 16: clusters of 4), at the
    speculative draft's propose shape of phases 25-26 (B 8: clusters of
    8) and at head dims 128 and 256, bf16 and fp32 q: within TOL,
    length-0 rows exact zeros, two calls bit-identical; then
    `decode_times` at the serving shape over lengths 0-1024 and over
    serving lengths → (checked rows, timed rows)."""
    gen = torch.Generator(device="cuda").manual_seed(7 + int(int8))
    name = "paged_decode_int8" if int8 else "paged_decode"
    design = getattr(da, "kernel_design", lambda q, kp: "single")
    rows = []
    for shape in (dict(B=16, H=12, D=64, ps=64, NP=16, P=513),
                  dict(B=8, H=12, D=64, ps=64, NP=16, P=513),
                  dict(B=3, H=2, D=128, ps=16, NP=8, P=40),
                  dict(B=5, H=4, D=256, ps=32, NP=4, P=30)):
        for dtype in (torch.bfloat16, torch.float32):
            q, table, lengths = decode_query_case(dtype, gen, **shape)
            pools = decode_pools(gen, 2, shape["P"], shape["H"],
                                 shape["ps"], shape["D"], dtype, int8)
            views = tuple(p[1] for p in pools)
            out = decode_call(da, q, views, table, lengths)
            again = decode_call(da, q, views, table, lengths)
            ref = decode_reference(da, q, views, table, lengths)
            torch.cuda.synchronize()
            tol = TOL[dtype]["out"]
            err, ok = close(out, ref, *tol)
            zero_ok = bool((out[lengths == 0] == 0).all())
            same = torch.equal(out, again)
            row = {"dtype": str(dtype), "max_abs_err": err, "tol": tol,
                   "design": design(q, views[0]), "two_calls_identical": same,
                   **shape}
            if row["design"] == "cluster":
                row["cluster"] = da.launch_plan(shape["B"], shape["H"],
                                                shape["NP"])
            print(f"  {name} {row}", flush=True)
            if not (ok and zero_ok and same and out.dtype == dtype):
                fail(f"{name} kernel disagrees with its plain version "
                     f"(zero rows exact: {zero_ok}, bit-identical: {same}): "
                     f"{row}")
            rows.append(row)
            del pools, views
        torch.cuda.empty_cache()
    timed = [decode_times(da, gen, int8, serving)
             for serving in (False, True)]
    report[name] = {"checked": rows, "timed": timed}
    return timed


def qmm_bound_ms(x, qw):
    """x read, the int8 weight and fp32 scales read, y written once;
    2·M·N·K flops."""
    M, K = x.shape
    N = qw.qval.shape[1]
    esize = x.element_size()
    nbytes = M * K * esize + K * N + 4 * N + M * N * esize
    return bound_ms(nbytes, 2 * M * N * K)


def qmm_case(qm, gen, M, K, N, dtype):
    """The kernel against its plain version on one (M, K, N) → (row of
    errors, x, the quantized weight); fails the run on a disagreement."""
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = 0.02 * torch.randn(K, N, generator=gen, device="cuda")
    qw = qm.quantize_weight(w.to(dtype))
    out = qm.quant_matmul_cuda(x, qw)
    ref = qm.quant_matmul_reference(x, qw)
    torch.cuda.synchronize()
    tol = TOL_QMM[dtype] * float(ref.float().abs().max())
    err, ok = close(out, ref, tol, 0.0)
    row = {"M": M, "K": K, "N": N, "dtype": str(dtype),
           "plan": qm.launch_plan(M, N, K), "max_abs_err": err,
           "tol": tol, "tol_rel_max": TOL_QMM[dtype]}
    print(f"  quant_matmul {row}", flush=True)
    if not ok or out.dtype != dtype:
        fail(f"int8 matmul kernel disagrees with its plain version: {row}")
    return row, x, qw


def qmm_times(qm, gen, row, x, qw):
    """Kernel, plain and library times of one bf16 case into ``row``:
    distinct weights are cycled through, so each launch reads its weight
    from device memory."""
    M, K = x.shape
    N = qw.qval.shape[1]
    n_w = -(-QMM_COLD_BYTES // (K * N))
    qws = [qw] + [qm.quantize_weight(
        (0.02 * torch.randn(K, N, generator=gen, device="cuda")).to(x.dtype))
        for _ in range(n_w - 1)]
    wds = [q.dequant(x.dtype) for q in qws]
    it = {"i": 0}

    def nxt(seq):
        it["i"] = (it["i"] + 1) % len(seq)
        return seq[it["i"]]
    row["ms"] = time_ms(lambda: qm.quant_matmul_cuda(x, nxt(qws)))
    row["plain_ms"] = time_ms(
        lambda: qm.quant_matmul_reference(x, nxt(qws)), warmup=2, iters=10)
    row["library_ms"] = time_ms(lambda: torch.matmul(x, nxt(wds)))
    row["bound_ms"], row["bound_by"] = qmm_bound_ms(x, qw)
    row["weights_cycled"] = n_w
    # one graph launch a distinct weight: all n_w of them
    row["graph_ms"] = graph_ms(lambda: qm.quant_matmul_cuda(x, nxt(qws)),
                               launches=n_w)
    row["plain_graph_ms"] = graph_ms(
        lambda: qm.quant_matmul_reference(x, nxt(qws)), launches=n_w,
        replays=2)
    row["library_graph_ms"] = graph_ms(lambda: torch.matmul(x, nxt(wds)),
                                       launches=n_w)
    print(f"  quant_matmul times M={M} K={K} N={N}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); in a CUDA graph: kernel "
          f"{row['graph_ms']:.4f} ms, plain {row['plain_graph_ms']:.4f} ms, "
          f"library {row['library_graph_ms']:.4f} ms", flush=True)


def qmm_readout(qm, gen, M, K=768, N=3072, dtype=torch.bfloat16):
    """One-hot rows of x over an int8 weight that holds all 256 values:
    y[m, n] = bf16(q[m % K, n] · scale[n]) exactly (fp16 with ``dtype``),
    so the kernel's int8 widening must give the plain version bit for
    bit → mismatches."""
    q = (torch.arange(K * N, device="cuda") % 256 - 128).to(
        torch.int8).reshape(K, N)
    scale = torch.rand(N, generator=gen, device="cuda") + 0.5
    qw = qm.QuantizedWeight(q, scale)
    x = torch.zeros(M, K, dtype=dtype, device="cuda")
    x[torch.arange(M), torch.arange(M) % K] = 1.0
    got = qm.quant_matmul_cuda(x, qw)
    want = qm.quant_matmul_reference(x, qw)
    torch.cuda.synchronize()
    return int((got != want).sum())


def qmm_host_us(qm, gen, M=16, K=768, N=3072, calls=2000):
    """The wrapper's host microseconds a call at decode rows: ``calls``
    calls on the host clock with no synchronization in between (the
    device's few microseconds a call hide behind them)."""
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    qw = qm.quantize_weight(
        (0.02 * torch.randn(K, N, generator=gen, device="cuda")).to(
            torch.bfloat16))
    for _ in range(50):
        qm.quant_matmul_cuda(x, qw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        qm.quant_matmul_cuda(x, qw)
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def check_quant_matmul(qm, gen, report):
    """The weight-only int8 matmul against its plain version, bf16 and
    fp32: all four GPT-NeoX-125M block weights at the decode (16) and
    prefill (256) rows of phase 9 and at serve-125M's top bucket (4096),
    mlp-in and mlp-out timed in bf16 at every M; the bf16 kernel's int8
    widening read out bit for bit and two calls compared bit for bit (the
    cluster's K reduction); the wrapper's host microseconds a call; then
    ragged and strided cases, and inputs it must refuse."""
    rows = []
    identical = True
    for dtype in (torch.bfloat16, torch.float32):
        for M in QMM_PATH_ROWS + (4096,):
            for K, N in QMM_BLOCK_SHAPES:
                row, x, qw = qmm_case(qm, gen, M, K, N, dtype)
                if dtype == torch.bfloat16:
                    again = qm.quant_matmul_cuda(x, qw)
                    row["bit_identical"] = bool(torch.equal(
                        qm.quant_matmul_cuda(x, qw), again))
                    identical &= row["bit_identical"]
                    if (K, N) in QMM_SHAPES:
                        qmm_times(qm, gen, row, x, qw)
                rows.append(row)
                del x, qw
            torch.cuda.empty_cache()
    readout = {M: qmm_readout(qm, gen, M) for M in QMM_PATH_ROWS + (4096,)}
    host_us = qmm_host_us(qm, gen)
    print(f"  quant_matmul int8 widening readout mismatches {readout}; two "
          f"calls bit-identical: {identical}; host {host_us:.2f} us a call "
          f"at M=16", flush=True)
    if any(readout.values()) or not identical:
        fail(f"int8 matmul kernel: readout mismatches {readout}, two calls "
             f"bit-identical {identical}")
    report["quant_matmul_readout"] = {"mismatches": readout,
                                      "bit_identical": identical,
                                      "host_us_per_call_M16": host_us}
    # ragged M, K and N edges, rows read through a wider row stride; at
    # column offset 3 the rows are not 16-byte aligned, which only the
    # fp32 kernel reads (bf16 must refuse them, below); at offset 0 bf16
    # takes the wgmma kernel, with and without a cluster
    ragged = [(torch.float32, c) for c in (
        (5, 33, 24, 3), (37, 70, 100, 3), (100, 200, 48, 3),
        (1, 768, 2304, 3))]
    ragged += [(dt, c) for dt in (torch.bfloat16, torch.float32) for c in (
        (20, 104, 80, 0), (7, 3072, 768, 0), (300, 200, 96, 0),
        (1, 768, 2304, 0))]
    for dtype, (M, K, N, off) in ragged:
        wide = torch.randn(M, K + 8, generator=gen, device="cuda")
        x = wide.to(dtype)[:, off:K + off]
        w = 0.05 * torch.randn(K, N, generator=gen, device="cuda")
        w[:, 0] = 0.0                       # a zero column: scale 1
        qw = qm.quantize_weight(w.to(dtype))
        out = qm.quant_matmul_cuda(x, qw)
        ref = qm.quant_matmul_reference(x, qw)
        torch.cuda.synchronize()
        tol = TOL_QMM[dtype] * float(ref.float().abs().max())
        err, ok = close(out, ref, tol, 0.0)
        row = {"M": M, "K": K, "N": N, "dtype": str(dtype),
               "row_stride": x.stride(0), "column_offset": off,
               "plan": qm.launch_plan(M, N, K), "max_abs_err": err,
               "tol": tol}
        print(f"  quant_matmul {row}", flush=True)
        if not ok or not bool((out[:, 0] == 0).all()):
            fail(f"int8 matmul kernel disagrees with its plain version "
                 f"on a ragged case: {row}")
        rows.append(row)
    # what the kernel cannot read raises before any launch: bf16 rows 6
    # bytes off alignment, and a contraction dim with a stride (one row
    # and many)
    wide = torch.randn(4, 2 * 768 + 8, generator=gen, device="cuda")
    qw = qm.quantize_weight(
        0.05 * torch.randn(768, 2304, generator=gen, device="cuda"))
    before = qm.launches
    for x in (wide.to(torch.bfloat16)[:, 3:771], wide[:1, :2 * 768:2],
              wide[:, :2 * 768:2]):
        try:
            qm.quant_matmul_cuda(x, qw)
        except ValueError as err:
            print(f"  quant_matmul refuses {tuple(x.shape)} {x.dtype} "
                  f"strides {tuple(x.stride())}: {err}", flush=True)
            continue
        fail(f"int8 matmul kernel took an input it cannot read: "
             f"{tuple(x.shape)} {x.dtype} strides {tuple(x.stride())}")
    if qm.launches != before:
        fail("int8 matmul kernel launched on an input it refused")
    report["quant_matmul"] = rows
    return [r for r in rows if "ms" in r]


def flash_bwd_bound_ms(q, seg):
    """Backward bound: q, k, v, dO read and dq, dk, dv written once, lse
    and delta read; five S×S×D products over the live pairs."""
    B, S, H, D = q.shape
    esize = q.element_size()
    seg_bytes = B * S * 4 if seg is not None else 0
    nbytes = 7 * B * S * H * D * esize + 2 * B * H * S * 4 + seg_bytes
    return bound_ms(nbytes, 5 * 2 * H * D * live_pairs(seg, B, S))


def check_grads(fa, q, k, v, seg, gen):
    """Forward, then the backward kernels against the plain backward on
    the same (out, lse, dO) → (row of errors, ok, tensors for timing)."""
    B, S, H, D = q.shape
    out, lse = fa.flash_attention_cuda(q, k, v, seg)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(q.dtype)
    delta = fa.attention_delta(out, do)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, seg)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, seg)
    torch.cuda.synchronize()
    row, ok = {}, True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, good = close(g, w, *TOL_BWD[q.dtype])
        row[f"max_abs_err_{name}"] = err
        ok = ok and good
    return row, ok, (out, lse, do, delta)


def check_train_kernels(fa, ad, gen, report, n_params):
    """Phase 3 for the training path: flash forward (no segments) and
    backward at the training attention shape, the backward on ragged
    segments at other lengths and head dims, flat Adam at the model's
    parameter count."""
    import torch.nn.functional as F
    B, S, H, D = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], \
        TRAIN_SEQ, NEOX_125M["num_heads"], \
        NEOX_125M["hidden_size"] // NEOX_125M["num_heads"]
    fwd_rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
        out, lse = fa.flash_attention_cuda(q, k, v)
        ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v)
        torch.cuda.synchronize()
        err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
        err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
        fwd = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
               "max_abs_err_out": err_o, "max_abs_err_lse": err_l,
               "tol_out": TOL[dtype]["out"]}
        del ref_out, ref_lse
        row, ok, (out, lse, do, delta) = check_grads(fa, q, k, v, None, gen)
        bwd = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
               "tol": TOL_BWD[dtype], **row}
        print(f"  flash_fwd (train shape) {fwd}", flush=True)
        print(f"  flash_bwd {bwd}", flush=True)
        if not (ok_o and ok_l):
            fail(f"flash forward kernel disagrees with its plain version "
                 f"at the training shape: {fwd}")
        if not ok:
            fail(f"flash backward kernels disagree with their plain "
                 f"version: {bwd}")
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            fwd["ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v))
            fwd["plain_ms"] = time_ms(
                lambda: fa.flash_attention_segmented_reference(q, k, v))
            with torch.no_grad():
                fwd["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True))
            fwd["bound_ms"], fwd["bound_by"] = prefill_bound_ms(q, None)
            bwd["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, lse, do, delta))
            bwd["plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                         do),
                warmup=2, iters=10)
            o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)
            do_t = do.transpose(1, 2).contiguous()
            bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_t, retain_graph=True))
            bwd["bound_ms"], bwd["bound_by"] = flash_bwd_bound_ms(q, None)
            for name, r in (("flash_fwd (train shape)", fwd),
                            ("flash_bwd", bwd)):
                print(f"  {name} times: kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, library "
                      f"{r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']})",
                      flush=True)
            del qt, kt, vt, o_lib, do_t
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
        del q, k, v, out, lse, do, delta
        torch.cuda.empty_cache()
    # ragged segments (pad tail), lengths no multiple of the tile, the
    # other head dims (D = 256 runs 32-row tiles)
    for dtype in (torch.bfloat16, torch.float32):
        for S2, B2, H2, D2 in ((100, 2, 3, 128), (200, 1, 2, 256),
                               (256, 2, 2, 64)):
            q, k, v, seg, _ = prefill_case(S2, dtype, gen, B=B2, H=H2, D=D2)
            row, ok, _ = check_grads(fa, q, k, v, seg, gen)
            row = {"S": S2, "B": B2, "H": H2, "D": D2, "dtype": str(dtype),
                   "segments": True, **row}
            print(f"  flash_bwd {row}", flush=True)
            if not ok:
                fail(f"flash backward kernels disagree with their plain "
                     f"version: {row}")
            bwd_rows.append(row)
    seg_row = check_bwd_segments(fa, gen)
    bwd_rows.append(seg_row)
    report["flash_fwd_train"] = fwd_rows
    report["flash_bwd"] = bwd_rows
    adam_rows = check_adam(ad, gen, n_params)
    report["adam"] = adam_rows
    return fwd_rows[0], bwd_rows[0], adam_rows[0], seg_row


def check_bwd_segments(fa, gen):
    """The backward on the case only the tiled, segment-aware TPU
    backward covers: B=4 S=1024 H=12 D=64 bf16 with the ragged segments
    of the prefill check, timed against the plain backward and SDPA's
    backward under the same bool mask."""
    import torch.nn.functional as F
    q, k, v, seg, _ = prefill_case(1024, torch.bfloat16, gen)
    row, ok, (out, lse, do, delta) = check_grads(fa, q, k, v, seg, gen)
    B, S, H, D = q.shape
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(q.dtype),
           "segments": True, "tol": TOL_BWD[q.dtype], **row}
    if not ok:
        fail(f"flash backward kernels disagree with their plain version on "
             f"ragged segments: {row}")
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None] & \
        (seg[:, :, None] == seg[:, None, :])
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    row["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, lse, do, delta, seg))
    row["plain_ms"] = time_ms(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, seg),
        warmup=2, iters=10)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                           attn_mask=mask[:, None])
    do_t = do.transpose(1, 2).contiguous()
    row["library_ms"] = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    row["bound_ms"], row["bound_by"] = flash_bwd_bound_ms(q, seg)
    row["live_pairs"] = live_pairs(seg, B, S)
    print(f"  flash_bwd (ragged segments) {row}", flush=True)
    del qt, kt, vt, o_lib, do_t
    torch.cuda.empty_cache()
    return row


def check_adam(ad, gen, n_params):
    hp = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
    rows = []
    for n, g_dtype in ((n_params, torch.bfloat16), (n_params, torch.float32),
                       (1000, torch.bfloat16), (1000, torch.float32)):
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
        m = 0.1 * torch.randn(n, generator=gen, device="cuda")
        v = 0.01 * torch.rand(n, generator=gen, device="cuda")
        want = ad.adam_flat_reference(p, g, m, v, 6e-4, 3, **hp)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        copy = torch.empty(n, dtype=torch.bfloat16, device="cuda")
        ad.adam_cuda(pk, g, mk, vk, 6e-4, 3, adam_w=True,
                     bias_correction=True, p_out=copy, **hp)
        torch.cuda.synchronize()
        row, ok = {"n": n, "g_dtype": str(g_dtype)}, True
        for name, got, ref in (("p", pk, want[0]), ("m", mk, want[1]),
                               ("v", vk, want[2])):
            err, good = close(got, ref, *TOL_ADAM)
            row[f"max_abs_err_{name}"] = err
            ok = ok and good
        row["bf16_copy_is_recast"] = bool(torch.equal(
            copy, pk.to(torch.bfloat16)))
        row["tol"] = TOL_ADAM
        print(f"  adam {row}", flush=True)
        if not (ok and row["bf16_copy_is_recast"]):
            fail(f"flat Adam kernel disagrees with its plain version: {row}")
        if n == n_params and g_dtype == torch.bfloat16:
            row["ms"] = time_ms(lambda: ad.adam_cuda(
                pk, g, mk, vk, 6e-4, 3, adam_w=True, bias_correction=True,
                p_out=copy, **hp))
            row["plain_ms"] = time_ms(lambda: ad.adam_flat_reference(
                p, g, m, v, 6e-4, 3, **hp), warmup=2, iters=10)
            # the library yardstick: fused AdamW on one flat fp32 tensor
            # (its grads must share the parameter's dtype)
            lib_p = torch.nn.Parameter(p.clone())
            lib_p.grad = g.float()
            lib = torch.optim.AdamW([lib_p], lr=6e-4, betas=(0.9, 0.95),
                                    eps=1e-8, weight_decay=0.01, fused=True)
            row["library_ms"] = time_ms(lib.step)
            # p, m, v read and written, g read, the bf16 copy written
            nbytes = n * (3 * 8 + g.element_size() + 2)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 14 * n)
            print(f"  adam times n={n}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']})",
                  flush=True)
            del lib_p, lib
        rows.append(row)
        del p, g, m, v, pk, mk, vk, copy, want
        torch.cuda.empty_cache()
    return rows


def gmm_live_rows(sizes, span):
    """[len(sizes) · span] bool: the live rows of a grouped buffer."""
    sz = torch.tensor(sizes, device="cuda")
    return (torch.arange(span, device="cuda")[None] < sz[:, None]).reshape(-1)


def gmm_bound_ms(sizes, K, N, W, esize, dw=False):
    """Forward: live x rows and w read, all of y written; dW: live x and
    dy rows read, the fp32 dW written. 2·Σsizes·K·N flops either way."""
    live, R = sum(sizes), len(sizes) * GMM_SPAN
    if dw:
        nbytes = live * (K + N) * esize + W * K * N * 4
    else:
        nbytes = live * K * esize + W * K * N * esize + R * N * esize
    return bound_ms(nbytes, 2 * live * K * N)


def gmm_case(gm, gen, sizes, span, K, N, W, lut, dtype):
    """The forward kernel, dx through the autograd function and the dW
    kernel against the plain versions on one case → (row, tensors);
    fails the run on a disagreement, a non-zero dead row or a non-zero dW
    of an expert without rows."""
    R = len(sizes) * span
    x = torch.randn(R, K, generator=gen, device="cuda").to(dtype)
    w = (0.02 * torch.randn(W, K, N, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(R, N, generator=gen, device="cuda").to(dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lut_t = tuple(range(W)) if lut is None else lut
    dead = ~gmm_live_rows(sizes, span)
    y = gm.grouped_matmul_cuda(x, w, sz, span, lut)
    ref = gm.grouped_matmul_reference(x, w, sz, span, lut)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    gm.grouped_matmul(xk, wk, sz, span, lut).backward(dy)
    xr = x.clone().requires_grad_()
    gm.grouped_matmul_reference(xr, w, sz, span, lut).backward(dy)
    dw = gm.grouped_matmul_dw_cuda(x, dy, sz, span, lut_t, W)
    dw_ref = gm.grouped_matmul_dw_reference(x, dy, sz, span, lut_t, W)
    torch.cuda.synchronize()
    tol = TOL_GMM[dtype]
    err_y, ok_y = close(y, ref, tol * float(ref.float().abs().max()), 0.0)
    err_dx, ok_dx = close(xk.grad, xr.grad,
                          tol * float(xr.grad.float().abs().max()), 0.0)
    err_dw, ok_dw = close(dw, dw_ref,
                          TOL_GMM_DW * float(dw_ref.abs().max()), 0.0)
    empty = [e for e in range(W)
             if all(s == 0 for s, l in zip(sizes, lut_t) if l == e)]
    row = {"sizes": list(sizes), "span": span, "K": K, "N": N, "W": W,
           "lut": list(lut_t), "dtype": str(dtype), "max_abs_err": err_y,
           "max_abs_err_dx": err_dx, "max_abs_err_dw": err_dw,
           "tol_rel_max": tol, "tol_dw_rel_max": TOL_GMM_DW,
           "dead_rows_exact_zero": bool(
               torch.equal(y[dead], torch.zeros_like(y[dead])) and
               torch.equal(xk.grad[dead], torch.zeros_like(xk.grad[dead]))),
           "empty_experts": empty,
           "empty_dw_exact_zero": all(
               torch.equal(dw[e], torch.zeros_like(dw[e])) for e in empty),
           # the autograd function's dW is the kernel's fp32 dW cast, and
           # the kernel sums in a fixed order: bit-equal across calls
           "dw_grad_is_kernel_cast": bool(torch.equal(wk.grad,
                                                      dw.to(dtype)))}
    print(f"  grouped_matmul {row}", flush=True)
    if not (ok_y and ok_dx and ok_dw and row["dead_rows_exact_zero"] and
            row["empty_dw_exact_zero"] and row["dw_grad_is_kernel_cast"]
            and y.dtype == dtype):
        fail(f"grouped matmul kernels disagree with their plain versions: "
             f"{row}")
    return row, (x, w, dy, sz)


def gmm_times(gm, row, x, w, dy, sz):
    """Event and CUDA-graph times of the forward (and the dx product) and
    of the dW kernel, their plain versions and one torch.bmm over the
    padded [E, span, ·] buffers, into ``row``."""
    R, K = x.shape
    W, _, N = w.shape
    sizes = row["sizes"]
    lut = tuple(range(W))
    xb, dyb = x.view(W, GMM_SPAN, K), dy.view(W, GMM_SPAN, N)
    row["ms"] = time_ms(lambda: gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN))
    row["graph_ms"] = graph_ms(
        lambda: gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN), launches=10,
        replays=3)
    row["dx_ms"] = time_ms(lambda: gm.grouped_matmul_cuda(
        dy, w, sz, GMM_SPAN, transpose_w=True))
    row["dx_graph_ms"] = graph_ms(lambda: gm.grouped_matmul_cuda(
        dy, w, sz, GMM_SPAN, transpose_w=True), launches=10, replays=3)
    wt = w.transpose(1, 2)
    row["dx_library_ms"] = time_ms(lambda: torch.bmm(dyb, wt))
    row["dx_library_graph_ms"] = graph_ms(lambda: torch.bmm(dyb, wt),
                                          launches=10, replays=3)
    # dx: live dy rows and w read, all of dx written, the same flops
    row["dx_bound_ms"], row["dx_bound_by"] = gmm_bound_ms(
        sizes, N, K, W, x.element_size())
    row["plain_ms"] = time_ms(
        lambda: gm.grouped_matmul_reference(x, w, sz, GMM_SPAN), warmup=2,
        iters=10)
    row["library_ms"] = time_ms(lambda: torch.bmm(xb, w))
    row["library_graph_ms"] = graph_ms(lambda: torch.bmm(xb, w),
                                       launches=10, replays=3)
    row["bound_ms"], row["bound_by"] = gmm_bound_ms(sizes, K, N, W,
                                                    x.element_size())
    row["dw_ms"] = time_ms(lambda: gm.grouped_matmul_dw_cuda(
        x, dy, sz, GMM_SPAN, lut, W))
    row["dw_graph_ms"] = graph_ms(lambda: gm.grouped_matmul_dw_cuda(
        x, dy, sz, GMM_SPAN, lut, W), launches=10, replays=3)
    row["dw_plain_ms"] = time_ms(lambda: gm.grouped_matmul_dw_reference(
        x, dy, sz, GMM_SPAN, lut, W), warmup=2, iters=10)
    row["dw_library_ms"] = time_ms(lambda: torch.bmm(xb.transpose(1, 2),
                                                     dyb))
    row["dw_library_graph_ms"] = graph_ms(
        lambda: torch.bmm(xb.transpose(1, 2), dyb), launches=10, replays=3)
    row["dw_bound_ms"], row["dw_bound_by"] = gmm_bound_ms(
        sizes, K, N, W, x.element_size(), dw=True)
    print(f"  grouped_matmul times K={K} N={N}: forward {row['ms']:.4f} ms "
          f"(graph {row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
          f"torch.bmm {row['library_ms']:.4f} ms (graph "
          f"{row['library_graph_ms']:.4f}), bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); dx {row['dx_ms']:.4f} ms (graph "
          f"{row['dx_graph_ms']:.4f}), torch.bmm(dy, wᵀ) "
          f"{row['dx_library_ms']:.4f} ms (graph "
          f"{row['dx_library_graph_ms']:.4f}), bound "
          f"{row['dx_bound_ms']:.5f} ms ({row['dx_bound_by']}); dW "
          f"{row['dw_ms']:.4f} ms (graph {row['dw_graph_ms']:.4f}), plain "
          f"{row['dw_plain_ms']:.4f} ms, torch.bmm "
          f"{row['dw_library_ms']:.4f} ms (graph "
          f"{row['dw_library_graph_ms']:.4f}), bound {row['dw_bound_ms']:.5f} "
          f"ms ({row['dw_bound_by']})", flush=True)


def gmm_nan_dead_rows(gm, gen, K, N, sizes=(200, 57, 0, 133), span=200):
    """The bf16 forward, dx and dW on spans that no 128-row tile (dW: no
    64-row stage) divides, dead rows of x and dy filled with NaN: the last
    tile of a span reads the next span's rows, and no bit of a dead row
    may reach a live one → (max relative error of the live rows of y and
    dx, dead rows exact zeros, the dW's max relative error against the
    plain version, the dW finite and the empty weight's exact zeros)."""
    R, W = len(sizes) * span, len(sizes)
    dead = ~gmm_live_rows(sizes, span)
    x = torch.randn(R, K, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(R, N, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(W, K, N, generator=gen, device="cuda")).to(
        torch.bfloat16)
    sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    xn, dyn = x.clone(), dy.clone()
    xn[dead] = float("nan")
    dyn[dead] = float("nan")
    x[dead] = 0
    dy[dead] = 0
    outs = (gm.grouped_matmul_cuda(xn, w, sz, span),
            gm.grouped_matmul_cuda(dyn, w, sz, span, transpose_w=True))
    refs = (gm.grouped_matmul_reference(x, w, sz, span),
            gm.grouped_matmul_reference(dy, w.transpose(1, 2), sz, span))
    torch.cuda.synchronize()
    err = max(float((o[~dead].float() - r[~dead].float()).abs().max()) /
              float(r[~dead].float().abs().max()) for o, r in zip(outs, refs))
    zero = all(bool((o[dead] == 0).all()) for o in outs)
    lut = tuple(range(W))
    dw = gm.grouped_matmul_dw_cuda(xn, dyn, sz, span, lut, W)
    dw_ref = gm.grouped_matmul_dw_reference(x, dy, sz, span, lut, W)
    torch.cuda.synchronize()
    err_dw = float((dw - dw_ref).abs().max()) / float(dw_ref.abs().max())
    dw_ok = bool(torch.isfinite(dw).all()) and all(
        bool((dw[e] == 0).all()) for e in range(W) if sizes[e] == 0)
    return err, zero, err_dw, dw_ok


def check_grouped_matmul(gm, gen, report):
    """Phase 3 for the MoE path: both grouped-matmul kernels against
    their plain versions at phase 11's geometry in bf16 and fp32 (timed
    in bf16; two bf16 forward, dx and dW calls compared bit for bit), on
    the small many-spans-per-weight LUT case, and the bf16 forward, dx
    and dW on spans no tile divides with NaN-filled dead rows."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in GMM_SHAPES:
            row, (x, w, dy, sz) = gmm_case(gm, gen, GMM_SIZES, GMM_SPAN, K,
                                           N, len(GMM_SIZES), None, dtype)
            if dtype == torch.bfloat16:
                lut = tuple(range(len(GMM_SIZES)))
                row["bit_identical"] = bool(
                    torch.equal(gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN),
                                gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN))
                    and torch.equal(
                        gm.grouped_matmul_cuda(dy, w, sz, GMM_SPAN,
                                               transpose_w=True),
                        gm.grouped_matmul_cuda(dy, w, sz, GMM_SPAN,
                                               transpose_w=True)))
                row["dw_bit_identical"] = torch.equal(
                    gm.grouped_matmul_dw_cuda(x, dy, sz, GMM_SPAN, lut,
                                              len(lut)),
                    gm.grouped_matmul_dw_cuda(x, dy, sz, GMM_SPAN, lut,
                                              len(lut)))
                err, zero, err_dw, dw_ok = gmm_nan_dead_rows(gm, gen, K, N)
                row["nan_dead_rows"] = {"max_rel_err": err,
                                        "dead_rows_exact_zero": zero,
                                        "dw_max_rel_err": err_dw,
                                        "dw_finite_empty_zero": dw_ok}
                print(f"  grouped_matmul K={K} N={N}: two calls "
                      f"bit-identical {row['bit_identical']} (dW "
                      f"{row['dw_bit_identical']}); spans of 200 with NaN "
                      f"dead rows: rel err {err:.2e}, dead rows exact zero "
                      f"{zero}; dW rel err {err_dw:.2e}, finite with the "
                      f"empty weight exact zeros {dw_ok}", flush=True)
                if not (row["bit_identical"] and zero and
                        err <= TOL_GMM[dtype]):
                    fail(f"grouped matmul forward/dx kernel: {row}")
                if not (row["dw_bit_identical"] and dw_ok and
                        err_dw <= TOL_GMM_DW):
                    fail(f"grouped matmul dW kernel: {row}")
                gmm_times(gm, row, x, w, dy, sz)
            rows.append(row)
            del x, w, dy, sz
            torch.cuda.empty_cache()
        row, _ = gmm_case(gm, gen, dtype=dtype, **GMM_LUT_CASE)
        rows.append(row)
    report["grouped_matmul"] = rows
    return [r for r in rows if "ms" in r]


# ---------------------------------------------------------------------------
# phase 3: the block-sparse and layout-masked flash kernels
# ---------------------------------------------------------------------------

def sparse_layout(block, S, H=12):
    from deeperspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict
    return sparsity_config_from_dict(dict(block, num_heads=H)).make_layout(S)


def sparse_live_pairs(layout, causal, B):
    """Live (row, key) pairs of a 128-grain layout: an active block gives
    128·128 of them, a diagonal one under causal 128·129/2, one above the
    diagonal under causal none."""
    lay = np.asarray(layout) != 0
    n, g = lay.shape[1], 128
    if not causal:
        return int(B * lay.sum() * g * g)
    diag = int(lay[:, np.arange(n), np.arange(n)].sum())
    lower = int(np.tril(lay, -1).sum())
    return B * (lower * g * g + diag * g * (g + 1) // 2)


def attn_bound_ms(q, pairs, part, extra_bytes=0):
    """Bound of one attention pass over ``pairs`` live pairs: "fwd" reads
    q, k, v and writes out and lse (4·D flops a pair); "dkv" reads q, k,
    v, dO, lse, delta and writes dk, dv (8·D); "dq" the same, writing dq
    (6·D); "bwd" is dkv and dq together (10·D)."""
    B, S, H, D = q.shape
    t = B * S * H * D * q.element_size()
    row = B * H * S * 4
    nbytes, flops = {"fwd": (4 * t + row, 4 * D),
                     "dkv": (6 * t + 2 * row, 8 * D),
                     "dq": (5 * t + 2 * row, 6 * D),
                     "bwd": (7 * t + 2 * row, 10 * D)}[part]
    return bound_ms(nbytes + extra_bytes, flops * pairs)


def sdpa_times(q, k, v, do, mask):
    """The library yardstick: SDPA forward and backward under the boolean
    token mask [1, H, S, S] (timed only). Returns (fwd ms, bwd ms, the
    batch it ran at): the whole batch, or its first row where the mask's
    float bias for all of it does not fit."""
    import torch.nn.functional as F
    for b in (q.shape[0], 1):
        try:
            qt, kt, vt = (t[:b].transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            do_t = do[:b].transpose(1, 2).contiguous()
            with torch.no_grad():
                fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), warmup=2, iters=5)
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            bwd = time_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), do_t, retain_graph=True), warmup=2,
                iters=5)
            return fwd, bwd, b
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    fail("SDPA with the sparse token mask does not fit at batch 1")


def token_mask(layout, causal):
    """[1, H, S, S] bool: the layout's blocks, ANDed with causal."""
    from deeperspeed_tpu_torch.ops.sparse_attention import \
        layout_to_token_mask
    mask = torch.as_tensor(layout_to_token_mask(layout, 128),
                           device="cuda")[None]
    if causal:
        mask &= torch.ones(mask.shape[-1], mask.shape[-1], dtype=torch.bool,
                           device="cuda").tril()
    return mask


def check_sparse_grads(bsa, fa, q, k, v, luts, causal, out, lse, gen,
                       tol=None):
    """The block-sparse backward kernels against the plain backward on the
    same (out, lse, dO), and dq, dk, dv through the autograd function
    against the plain versions' → (row, ok, (do, delta))."""
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    delta = fa.attention_delta(out, do)
    dk, dv = bsa.block_sparse_attention_dkv_cuda(q, k, v, lse, do, delta,
                                                 luts, causal)
    dq = bsa.block_sparse_attention_dq_cuda(q, k, v, lse, do, delta, luts,
                                            causal)
    want = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse, do,
                                                    luts, causal)
    att = bsa.BlockSparseAttention(luts.layout, causal=causal)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    att(*leaves).backward(do)
    torch.cuda.synchronize()
    row, ok = {}, True
    for name, g, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves,
                             want):
        err, good = close(g, w, *(tol or TOL_BWD[q.dtype]))
        err_a, good_a = close(a.grad, w, *(tol or TOL_BWD[q.dtype]))
        row[f"max_abs_err_{name}"] = max(err, err_a)
        ok = ok and good and good_a
    return row, ok, (do, delta)


def check_block_sparse(bsa, fa, gen, report):
    """Phase 3 for the block-sparse kernels: at phase 13's attention shape
    (B=2, S=16384, H=12, D=64, l16g1 causal) in bf16 and fp32, forward
    and backward against the plain versions, timed in bf16 beside the
    plain versions, SDPA under the token mask, the port's dense causal
    flash and the masked flash kernel on the same layout; then a small
    bidirectional layout with a dead row at every head dim."""
    B, S, H, D = 2, SPARSE_SEQ, 12, 64
    layout = sparse_layout(SPARSE_L16G1, S)
    luts = bsa.LayoutLuts(layout)
    pairs = sparse_live_pairs(layout, True, B)
    lut_bytes = sum(a.nbytes for a in luts.fwd + luts.bwd)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
        out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, True)
        ref_out, ref_lse = bsa.block_sparse_attention_reference(q, k, v,
                                                                luts, True)
        torch.cuda.synchronize()
        err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
        err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
        del ref_out, ref_lse
        grads, ok_g, (do, delta) = check_sparse_grads(bsa, fa, q, k, v, luts,
                                                      True, out, lse, gen)
        row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
               "layout": "fixed l16g1 causal", "density":
               float(np.asarray(layout, bool).mean()), "live_pairs": pairs,
               "max_abs_err_out": err_o, "max_abs_err_lse": err_l,
               "tol_out": TOL[dtype]["out"], "tol_bwd": TOL_BWD[dtype],
               **grads}
        print(f"  block_sparse {row}", flush=True)
        if not (ok_o and ok_l and ok_g):
            fail(f"block-sparse kernels disagree with their plain versions: "
                 f"{row}")
        if dtype == torch.bfloat16:
            row.update(sparse_bit_identity(bsa, q, k, v, lse, do, delta,
                                           luts, True))
            row["fwd_ms"] = time_ms(lambda: bsa.block_sparse_attention_cuda(
                q, k, v, luts, True), warmup=2, iters=10)
            row["dkv_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_dkv_cuda(
                    q, k, v, lse, do, delta, luts, True), warmup=2, iters=10)
            row["dq_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_dq_cuda(
                    q, k, v, lse, do, delta, luts, True), warmup=2, iters=10)
            row["plain_fwd_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_reference(q, k, v, luts,
                                                             True),
                warmup=1, iters=3)
            row["plain_bwd_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_bwd_reference(
                    q, k, v, out, lse, do, luts, True), warmup=1, iters=3)
            for part in ("fwd", "dkv", "dq"):
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = \
                    attn_bound_ms(q, pairs, part, lut_bytes)
            # the same layout through the masked flash kernel (the other
            # arm), and the port's dense causal flash: the crossover
            lay_t = torch.as_tensor(np.asarray(layout) != 0,
                                    dtype=torch.int32, device="cuda")
            row["masked_fwd_ms"] = time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, None, None, lay_t, True), warmup=2, iters=10)
            row["masked_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, lse, do, delta, None, None, lay_t, True),
                warmup=2, iters=5)
            d_out, d_lse = fa.flash_attention_cuda(q, k, v)
            row["dense_flash_fwd_ms"] = time_ms(
                lambda: fa.flash_attention_cuda(q, k, v), warmup=1, iters=3)
            d_delta = fa.attention_delta(d_out, do)
            row["dense_flash_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_cuda(q, k, v, d_lse, do,
                                                    d_delta),
                warmup=1, iters=3)
            del d_out, d_lse, d_delta
            mask = token_mask(layout, True)
            row["library_fwd_ms"], row["library_bwd_ms"], \
                row["library_batch"] = sdpa_times(q, k, v, do, mask)
            del mask
            print(f"  block_sparse times (bf16): forward {row['fwd_ms']:.4f} "
                  f"ms, dk/dv {row['dkv_ms']:.4f} ms, dq {row['dq_ms']:.4f} "
                  f"ms; plain {row['plain_fwd_ms']:.4f} / "
                  f"{row['plain_bwd_ms']:.4f} ms; SDPA (bool mask, B="
                  f"{row['library_batch']}) {row['library_fwd_ms']:.4f} / "
                  f"{row['library_bwd_ms']:.4f} ms; masked flash "
                  f"{row['masked_fwd_ms']:.4f} / {row['masked_bwd_ms']:.4f} "
                  f"ms; dense causal flash {row['dense_flash_fwd_ms']:.4f} / "
                  f"{row['dense_flash_bwd_ms']:.4f} ms; bounds "
                  f"{row['fwd_bound_ms']:.5f} / {row['dkv_bound_ms']:.5f} / "
                  f"{row['dq_bound_ms']:.5f} ms ({row['fwd_bound_by']})",
                  flush=True)
        rows.append(row)
        del q, k, v, out, lse, do, delta
        torch.cuda.empty_cache()
    rows.append(check_sparse_causal_d128(bsa, fa, gen))
    rows += check_sparse_dead_rows(bsa, fa, gen)
    report["block_sparse"] = rows
    return rows[0]


def sparse_bit_identity(bsa, q, k, v, lse, do, delta, luts, causal):
    """Two calls of each block-sparse kernel on the same inputs must be
    bit-identical (no atomics; every sum in a fixed order) → {"<part>_bit_
    identical": True}."""
    calls = {
        "fwd": lambda: bsa.block_sparse_attention_cuda(q, k, v, luts,
                                                       causal),
        "dkv": lambda: bsa.block_sparse_attention_dkv_cuda(
            q, k, v, lse, do, delta, luts, causal),
        "dq": lambda: (bsa.block_sparse_attention_dq_cuda(
            q, k, v, lse, do, delta, luts, causal),)}
    row = {}
    for part, call in calls.items():
        first, second = call(), call()
        row[f"{part}_bit_identical"] = all(
            torch.equal(a, b) for a, b in zip(first, second))
        del first, second
    print(f"  block_sparse {q.dtype} D={q.shape[-1]}: two calls "
          f"bit-identical {row}", flush=True)
    if not all(row.values()):
        fail(f"two block-sparse calls on the same inputs differ: {row}")
    return row


def check_sparse_causal_d128(bsa, fa, gen):
    """A causal bf16 layout at D = 128 (B=2, S=2048, H=4, fixed l4g1):
    forward and backward against the plain versions within TOL /
    TOL_BWD, and each kernel's two calls bit-identical."""
    B, S, H, D, dtype = 2, 2048, 4, 128, torch.bfloat16
    layout = sparse_layout(SPARSE_L4G1, S, H=H)
    luts = bsa.LayoutLuts(layout)
    q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
    out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, True)
    ref_out, ref_lse = bsa.block_sparse_attention_reference(q, k, v, luts,
                                                            True)
    torch.cuda.synchronize()
    err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
    err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
    grads, ok_g, (do, delta) = check_sparse_grads(bsa, fa, q, k, v, luts,
                                                  True, out, lse, gen)
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
           "layout": "fixed l4g1 causal", "max_abs_err_out": err_o,
           "max_abs_err_lse": err_l, "tol_out": TOL[dtype]["out"],
           "tol_bwd": TOL_BWD[dtype], **grads}
    print(f"  block_sparse causal D=128 {row}", flush=True)
    if not (ok_o and ok_l and ok_g):
        fail(f"block-sparse kernels disagree with their plain versions at "
             f"D 128, causal: {row}")
    row.update(sparse_bit_identity(bsa, q, k, v, lse, do, delta, luts, True))
    return row


def check_sparse_dead_rows(bsa, fa, gen):
    """A bidirectional layout (causal=False) with an empty layout row, at
    each head dim: both kernels' outputs and gradients against their
    plain versions, and the dead rows exactly 0 with lse = +1e30."""
    rows = []
    S, B, H = 512, 2, 3
    n = S // 128
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128, 256):
            layout = (torch.rand(H, n, n, generator=gen, device="cuda") <
                      0.5).cpu().numpy().astype(np.int32)
            layout[:, np.arange(n), np.arange(n)] = 1
            layout[1, 2] = 0                       # head 1, rows 256-383
            luts = bsa.LayoutLuts(layout)
            lay_t = torch.as_tensor(layout, device="cuda")
            q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
            row = {"S": S, "B": B, "H": H, "D": D, "dtype": str(dtype),
                   "causal": False, "dead_row": True}
            ok = True
            for name, fwd, ref in (
                    ("block_sparse", lambda: bsa.block_sparse_attention_cuda(
                        q, k, v, luts, False),
                     lambda: bsa.block_sparse_attention_reference(
                         q, k, v, luts, False)),
                    ("masked", lambda: fa.flash_attention_cuda(
                        q, k, v, None, None, lay_t, False),
                     lambda: fa.flash_attention_segmented_reference(
                         q, k, v, None, None, lay_t, False))):
                out, lse = fwd()
                ref_out, ref_lse = ref()
                err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
                err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
                dead = bool((out[:, 256:384, 1] == 0).all()) and \
                    bool((lse.view(B, H, S)[:, 1, 256:384] == 1e30).all())
                if name == "block_sparse":
                    g, ok_g, _ = check_sparse_grads(bsa, fa, q, k, v, luts,
                                                    False, out, lse, gen)
                else:
                    do = torch.randn(q.shape, generator=gen,
                                     device="cuda").to(dtype)
                    delta = fa.attention_delta(out, do)
                    got = fa.flash_attention_bwd_cuda(
                        q, k, v, lse, do, delta, None, None, lay_t, False)
                    want = fa.flash_attention_bwd_reference(
                        q, k, v, out, lse, do, None, None, lay_t, False)
                    g, ok_g = {}, True
                    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                        err, good = close(a, w, *TOL_BWD[dtype])
                        g[f"max_abs_err_{gname}"] = err
                        ok_g = ok_g and good
                    dead = dead and bool((got[0][:, 256:384, 1] == 0).all())
                row[name] = {"max_abs_err_out": err_o,
                             "max_abs_err_lse": err_l, "dead_rows_zero": dead,
                             **g}
                ok = ok and ok_o and ok_l and ok_g and dead
            print(f"  sparse dead rows {row}", flush=True)
            if not ok:
                fail(f"a sparse kernel disagrees with its plain version on a "
                     f"layout with a dead row: {row}")
            rows.append(row)
    return rows


def check_masked_flash(bsa, fa, gen, report):
    """Phase 3 for the layout mask on the flash kernels: phase 14(a)'s
    attention shape (B=16, S=1024, H=12, D=64, l4g1 causal) in bf16 and
    fp32 against the plain version, timed in bf16 beside it, SDPA under
    the token mask, the port's dense causal flash and the block-sparse
    kernels on the same layout."""
    B, S, H, D = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], TRAIN_SEQ, \
        12, 64
    layout = sparse_layout(SPARSE_L4G1, S)
    lay_t = torch.as_tensor(np.asarray(layout) != 0, dtype=torch.int32,
                            device="cuda")
    pairs = sparse_live_pairs(layout, True, B)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
        out, lse = fa.flash_attention_cuda(q, k, v, None, None, lay_t, True)
        ref_out, ref_lse = fa.flash_attention_segmented_reference(
            q, k, v, None, None, lay_t, True)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        delta = fa.attention_delta(out, do)
        got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, None, None,
                                          lay_t, True)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None,
                                                None, lay_t, True)
        torch.cuda.synchronize()
        err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
        err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
        row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
               "layout": "fixed l4g1 causal",
               "density": float(np.asarray(layout, bool).mean()),
               "live_pairs": pairs, "max_abs_err_out": err_o,
               "max_abs_err_lse": err_l, "tol_out": TOL[dtype]["out"],
               "tol_bwd": TOL_BWD[dtype]}
        ok = ok_o and ok_l
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, good = close(g, w, *TOL_BWD[dtype])
            row[f"max_abs_err_{name}"] = err
            ok = ok and good
        del ref_out, ref_lse, want
        print(f"  flash_masked {row}", flush=True)
        if not ok:
            fail(f"masked flash kernels disagree with their plain versions: "
                 f"{row}")
        if dtype == torch.bfloat16:
            row["fwd_ms"] = time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, None, None, lay_t, True))
            row["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, lse, do, delta, None, None, lay_t, True))
            row["plain_fwd_ms"] = time_ms(
                lambda: fa.flash_attention_segmented_reference(
                    q, k, v, None, None, lay_t, True), warmup=2, iters=10)
            row["plain_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do, None, None, lay_t, True),
                warmup=2, iters=10)
            for part in ("fwd", "bwd"):
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = \
                    attn_bound_ms(q, pairs, part, lay_t.numel() * 4)
            luts = bsa.LayoutLuts(layout)
            row["block_sparse_fwd_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_cuda(q, k, v, luts, True))
            row["block_sparse_bwd_ms"] = time_ms(
                lambda: bsa.block_sparse_attention_bwd_cuda(
                    q, k, v, lse, do, delta, luts, True))
            d_out, d_lse = fa.flash_attention_cuda(q, k, v)
            row["dense_flash_fwd_ms"] = time_ms(
                lambda: fa.flash_attention_cuda(q, k, v))
            d_delta = fa.attention_delta(d_out, do)
            row["dense_flash_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_cuda(q, k, v, d_lse, do,
                                                    d_delta))
            del d_out, d_lse, d_delta
            row["library_fwd_ms"], row["library_bwd_ms"], \
                row["library_batch"] = sdpa_times(q, k, v, do,
                                                  token_mask(layout, True))
            print(f"  flash_masked times (bf16): forward {row['fwd_ms']:.4f} "
                  f"ms, backward {row['bwd_ms']:.4f} ms; plain "
                  f"{row['plain_fwd_ms']:.4f} / {row['plain_bwd_ms']:.4f} ms; "
                  f"SDPA (bool mask, B={row['library_batch']}) "
                  f"{row['library_fwd_ms']:.4f} / {row['library_bwd_ms']:.4f}"
                  f" ms; block-sparse {row['block_sparse_fwd_ms']:.4f} / "
                  f"{row['block_sparse_bwd_ms']:.4f} ms; dense causal flash "
                  f"{row['dense_flash_fwd_ms']:.4f} / "
                  f"{row['dense_flash_bwd_ms']:.4f} ms; bounds "
                  f"{row['fwd_bound_ms']:.5f} / {row['bwd_bound_ms']:.5f} ms "
                  f"({row['fwd_bound_by']})", flush=True)
        rows.append(row)
        del q, k, v, out, lse, do, delta, got
        torch.cuda.empty_cache()
    report["flash_masked"] = rows
    return rows[0]


def check_sparse_crossover(bsa, fa, gen, report):
    """Where the two kernel arms cross on this card: the masked flash
    kernels and the block-sparse kernels, forward + backward in bf16, on
    four layouts at B=8, S=2048, H=12, D=64 whose densities lie on both
    sides of the routing's 0.25, beside the dense causal flash (timed
    only; the arm `SparseSelfAttention` picks is unchanged)."""
    B, S, H, D = 8, 2048, 12, 64
    q, k, v, _, _ = prefill_case(S, torch.bfloat16, gen, B=B, H=H, D=D)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)

    def fwd_bwd_ms(fwd, bwd):
        out, lse = fwd()
        delta = fa.attention_delta(out, do)
        return time_ms(fwd) + time_ms(lambda: bwd(lse, delta))

    rows = [{"layout": "dense causal flash", "density": None,
             "dense_flash_ms": fwd_bwd_ms(
                 lambda: fa.flash_attention_cuda(q, k, v),
                 lambda lse, delta: fa.flash_attention_bwd_cuda(
                     q, k, v, lse, do, delta))}]
    for name, block in (
            ("variable w1 g0", {"mode": "variable", "block": 128,
                                "local_window_blocks": [1],
                                "global_block_indices": [0],
                                "attention": "unidirectional"}),
            ("fixed l4g1", SPARSE_L4G1),
            ("fixed l8g1", dict(SPARSE_L4G1, num_local_blocks=8)),
            ("fixed l16g1 (dense causal)",
             dict(SPARSE_L4G1, num_local_blocks=16))):
        layout = sparse_layout(block, S)
        luts = bsa.LayoutLuts(layout)
        lay_t = torch.as_tensor(np.asarray(layout) != 0, dtype=torch.int32,
                                device="cuda")
        row = {"layout": name,
               "density": float(np.asarray(layout, bool).mean())}
        row["masked_flash_ms"] = fwd_bwd_ms(
            lambda: fa.flash_attention_cuda(q, k, v, None, None, lay_t, True),
            lambda lse, delta: fa.flash_attention_bwd_cuda(
                q, k, v, lse, do, delta, None, None, lay_t, True))
        row["block_sparse_ms"] = fwd_bwd_ms(
            lambda: bsa.block_sparse_attention_cuda(q, k, v, luts, True),
            lambda lse, delta: bsa.block_sparse_attention_bwd_cuda(
                q, k, v, lse, do, delta, luts, True))
        rows.append(row)
    for row in rows:
        print(f"  sparse crossover B={B} S={S} (forward + backward, bf16) "
              f"{row}", flush=True)
    report["sparse_crossover"] = rows
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the key-bias and dropout flags of the flash kernels (BERT)
# ---------------------------------------------------------------------------

def bert_attention_case(dtype, gen, B=BERT_MICRO, S=BERT_SEQ, H=16, D=64):
    """q, k, v as the fused layer hands them over (views split out of one
    [B, S, 3·H·D] projection), a ragged key bias whose last batch row is
    all masked, dO, the seed and the live keys of each batch row."""
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(
        dtype)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
    lens[0], lens[-1] = S, 0
    kbias = torch.where(torch.arange(S, device="cuda")[None] < lens[:, None],
                        0.0, -1e30)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    seed = torch.tensor([BERT_DROPOUT_SEED], dtype=torch.int32,
                        device="cuda")
    return q, k, v, kbias, do, seed, lens


def materialized_attention(q, k, v, kbias, seed, rate):
    """The fused layer's materialized path on [B, S, H, D] (short S):
    fp32 scores plus the key bias, softmax, the hash dropout on the
    probabilities, P·V in the input dtype."""
    from deeperspeed_tpu_torch.ops.transformer.transformer import _dropout
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits + kbias[:, None, None, :], dim=-1)
    probs = _dropout(probs.to(q.dtype), rate, seed.reshape(()), False)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def check_bert_attention(fa, gen, report):
    """Phase 3 for the fused BERT layer's attention: the flash forward and
    backward with the key-bias and dropout flags at BERT-large's shape
    (B=20, S=512, H=16, D=64, not causal), bf16 and fp32, rates 0 and
    0.1, against their plain versions, with exact zeros (lse +1e30) on
    the all-masked batch row; in bf16 each timed beside its plain
    version, SDPA under the float mask with dropout_p = rate (timed
    only) and its bound; then the kernel path and the materialized path
    (forward + backward, rate 0.1) at S = 128 and 512, where the layer
    switches between them."""
    import torch.nn.functional as F
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kbias, do, seed, lens = bert_attention_case(dtype, gen)
        B, S, H, D = q.shape
        pairs = int(lens.sum()) * S * H
        for rate in (0.0, 0.1):
            flags = (None, None, None, False, kbias, seed, rate)
            out, lse = fa.flash_attention_cuda(q, k, v, *flags)
            ref_out, ref_lse = fa.flash_attention_segmented_reference(
                q, k, v, *flags)
            delta = fa.attention_delta(out, do)
            got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta,
                                              *flags)
            want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                    *flags)
            torch.cuda.synchronize()
            row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
                   "rate": rate, "live_pairs": pairs,
                   "tol_out": TOL_FLAGS[dtype]["out"],
                   "tol_bwd": TOL_FLAGS[dtype]["bwd"]}
            row["max_abs_err_out"], ok = close(out, ref_out,
                                               *TOL_FLAGS[dtype]["out"])
            row["max_abs_err_lse"], ok_l = close(lse, ref_lse,
                                                 *TOL[dtype]["lse"])
            ok = ok and ok_l
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                row[f"max_abs_err_{name}"], good = close(
                    g, w, *TOL_FLAGS[dtype]["bwd"])
                ok = ok and good
            dead = bool((out[-1] == 0).all()) and \
                bool((lse[-H:] == 1e30).all()) and \
                all(bool((g[-1] == 0).all()) for g in got)
            print(f"  flash kbias/dropout {row}, dead row exact: {dead}",
                  flush=True)
            if not ok:
                fail(f"flash kernels with the key-bias/dropout flags "
                     f"disagree with their plain versions: {row}")
            if not dead:
                fail(f"the all-masked batch row is not exactly zero (lse "
                     f"+1e30) through the flagged flash kernels: {row}")
            del ref_out, ref_lse, want
            if dtype == torch.bfloat16:
                row["ms"] = time_ms(lambda: fa.flash_attention_cuda(
                    q, k, v, *flags))
                row["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, lse, do, delta, *flags))
                row["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_segmented_reference(
                        q, k, v, *flags), warmup=2, iters=10)
                row["plain_bwd_ms"] = time_ms(
                    lambda: fa.flash_attention_bwd_reference(
                        q, k, v, out, lse, do, *flags), warmup=2, iters=10)
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              .requires_grad_() for t in (q, k, v))
                mask = kbias[:, None, None, :].to(dtype)
                with torch.no_grad():
                    row["library_ms"] = time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, dropout_p=rate))
                o_lib = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=rate)
                do_t = do.transpose(1, 2).contiguous()
                row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), do_t, retain_graph=True))
                row["library"] = (f"SDPA, float mask [B, 1, 1, S], "
                                  f"dropout_p={rate}")
                row["bound_ms"], row["bound_by"] = attn_bound_ms(
                    q, pairs, "fwd", extra_bytes=B * S * 4)
                row["bwd_bound_ms"], row["bwd_bound_by"] = attn_bound_ms(
                    q, pairs, "bwd", extra_bytes=B * S * 4)
                print(f"  flash kbias/dropout rate {rate} times: forward "
                      f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                      f"SDPA {row['library_ms']:.4f}, bound "
                      f"{row['bound_ms']:.5f} {row['bound_by']}), backward "
                      f"{row['bwd_ms']:.4f} ms (plain "
                      f"{row['plain_bwd_ms']:.4f}, SDPA "
                      f"{row['library_bwd_ms']:.4f}, bound "
                      f"{row['bwd_bound_ms']:.5f} {row['bwd_bound_by']})",
                      flush=True)
                del qt, kt, vt, o_lib, do_t
            rows.append(row)
            del out, lse, got, delta
        del q, k, v, do
        torch.cuda.empty_cache()
    # where the layer switches paths: fused kernels vs materialized
    switch = []
    for S in (128, BERT_SEQ):
        q, k, v, kbias, do, seed, _ = bert_attention_case(torch.bfloat16,
                                                          gen, S=S)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def fused():
            o = fa.flash_attention_train(qg, kg, vg, kbias, seed,
                                         dropout_rate=0.1)
            torch.autograd.grad(o, (qg, kg, vg), do)

        def materialized():
            o = materialized_attention(qg, kg, vg, kbias, seed, 0.1)
            torch.autograd.grad(o, (qg, kg, vg), do)

        r = {"S": S, "B": BERT_MICRO, "kernel_ms": time_ms(fused),
             "materialized_ms": time_ms(materialized, warmup=2, iters=10)}
        print(f"  fused vs materialized attention, forward + backward, "
              f"rate 0.1, S={S}: kernels {r['kernel_ms']:.4f} ms, "
              f"materialized {r['materialized_ms']:.4f} ms", flush=True)
        switch.append(r)
        del q, k, v, qg, kg, vg, do
        torch.cuda.empty_cache()
    report["bert_attention"] = {"rows": rows, "path_switch": switch}
    return rows, switch


# ---------------------------------------------------------------------------
# phase 3: what the bf16 tolerances cannot see: the keep-mask the kernels
# draw, and run-to-run identity of the backward
# ---------------------------------------------------------------------------

def readout_kernels(fa):
    """(forward, dV) of the flagged flash kernels, not causal, for
    `dropout_readout`."""
    def fwd(q, k, v, kbias, seed, rate):
        return fa.flash_attention_cuda(q, k, v, None, None, None, False,
                                       kbias, seed, rate)

    def dv(q, k, v, out, lse, do, kbias, seed, rate):
        return fa.flash_attention_bwd_cuda(
            q, k, v, lse, do, fa.attention_delta(out, do), None, None, None,
            False, kbias, seed, rate)[2]
    return fwd, dv


def readout_plain(fa):
    """The same pair through the plain versions."""
    def fwd(q, k, v, kbias, seed, rate):
        return fa.flash_attention_segmented_reference(
            q, k, v, None, None, None, False, kbias, seed, rate)

    def dv(q, k, v, out, lse, do, kbias, seed, rate):
        return fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, None, None, None, False, kbias, seed,
            rate)[2]
    return fwd, dv


def dropout_readout(fwd, dv_fn, B, S, H, D, rate, seed, dtype, device):
    """The keep-masks [B, H, S, S] that a forward and a dV computation
    draw, read out of their outputs. q = k = 0 and a zero key bias make P
    uniform (1/S on every key), so a kept probability is nonzero and a
    dropped one exactly 0. Forward: v one-hot on one key per column
    (column d of call c carries key c·D + d), so out[b, row, h, d] != 0
    exactly where (row, c·D + d) is kept. dV: dO one-hot on one row per
    column, so dv[b, key, h, d] != 0 exactly where (c·D + d, key) is
    kept. S / D calls of each cover every key and every row."""
    zeros = torch.zeros(B, S, H, D, dtype=dtype, device=device)
    kbias = torch.zeros(B, S, dtype=torch.float32, device=device)
    fwd_mask = torch.empty(B, H, S, S, dtype=torch.bool, device=device)
    dv_mask = torch.empty_like(fwd_mask)
    cols = torch.arange(D, device=device)
    for c in range(S // D):
        sel = torch.zeros(S, D, dtype=dtype, device=device)
        sel[c * D + cols, cols] = 1
        onehot = sel[None, :, None, :].expand(B, S, H, D).contiguous()
        out, lse = fwd(zeros, zeros, onehot, kbias, seed, rate)
        fwd_mask[..., c * D:(c + 1) * D] = (out != 0).permute(0, 2, 1, 3)
        dv = dv_fn(zeros, zeros, zeros, out, lse, onehot, kbias, seed, rate)
        dv_mask[:, :, c * D:(c + 1) * D, :] = (dv != 0).permute(0, 2, 3, 1)
    return fwd_mask, dv_mask


def check_dropout_readout(fa, report):
    """The keep-mask of the bf16 forward and dk/dv kernels at BERT-large's
    shape (B=20, S=512, H=16, D=64, rate 0.1), read out by
    `dropout_readout`, must equal `dropout_keep` bit for bit: a mask
    drawn at wrong coordinates moves a bf16 output by about 0.015,
    inside the (2e-2, 2e-2) tolerance of the value checks."""
    B, S, H, D, rate = BERT_MICRO, BERT_SEQ, 16, 64, 0.1
    seed = torch.tensor([BERT_DROPOUT_SEED], dtype=torch.int32,
                        device="cuda")
    fa.reset_design_launches()
    fwd_mask, dv_mask = dropout_readout(*readout_kernels(fa), B, S, H, D,
                                        rate, seed, torch.bfloat16, "cuda")
    want = fa._keep_mask(seed, B, H, S, rate, "cuda")
    row = {"B": B, "S": S, "H": H, "D": D, "rate": rate,
           "calls": S // D, "kept_share": float(want.float().mean()),
           "forward_mismatches": int((fwd_mask != want).sum()),
           "dv_mismatches": int((dv_mask != want).sum()),
           "design_launches": {k: dict(v)
                               for k, v in fa.design_launches.items()}}
    print(f"  dropout mask readout {row}", flush=True)
    if row["forward_mismatches"] or row["dv_mismatches"]:
        fail(f"the keep-mask read out of the bf16 flash kernels is not "
             f"dropout_keep's: {row}")
    if row["design_launches"]["fwd"]["mma"] != S // D or \
            row["design_launches"]["dkv"]["mma"] != S // D:
        fail(f"the mask readout did not run the tensor-core kernels: {row}")
    report["dropout_readout"] = row
    return row


def check_bwd_identity(fa, gen, report):
    """Two bf16 backward calls on the same inputs give the same bits (no
    atomics): at the training shape (causal) and at BERT-large's shape
    with the key bias and dropout 0.1."""
    B, S, H, D = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], \
        TRAIN_SEQ, NEOX_125M["num_heads"], \
        NEOX_125M["hidden_size"] // NEOX_125M["num_heads"]
    q, k, v, _, _ = prefill_case(S, torch.bfloat16, gen, B=B, H=H, D=D)
    cases = [("train shape, causal", (q, k, v), (None, None, None, True))]
    bq, bk, bv, kbias, _, seed, _ = bert_attention_case(torch.bfloat16, gen)
    cases.append(("BERT shape, key bias + dropout 0.1", (bq, bk, bv),
                  (None, None, None, False, kbias, seed, 0.1)))
    rows = []
    for name, (q, k, v), flags in cases:
        out, lse = fa.flash_attention_cuda(q, k, v, *flags)
        do = torch.randn(out.shape, generator=gen, device="cuda").to(q.dtype)
        delta = fa.attention_delta(out, do)
        first = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, *flags)
        second = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, *flags)
        torch.cuda.synchronize()
        same = {g: bool(torch.equal(a, b))
                for g, a, b in zip(("dq", "dk", "dv"), first, second)}
        rows.append({"case": name, "shape": list(q.shape),
                     "bit_identical": same})
        print(f"  flash backward run to run ({name}): {same}", flush=True)
        if not all(same.values()):
            fail(f"two bf16 flash backward calls on the same inputs differ "
                 f"({name}): {same}")
        del out, lse, do, delta, first, second
    torch.cuda.empty_cache()
    report["flash_bwd_identity"] = rows
    return rows


def check_decode_design(da, what, launches, int8):
    """Every paged-decode launch of a bf16 serving path (bf16 or int8
    pools, D 64) took the cluster kernel, by the wrapper's per-design
    counters → {"paged_decode": counts, "paged_decode_int8": counts}."""
    got = {"paged_decode": dict(da.launches_by_design),
           "paged_decode_int8": dict(da.launches_by_design_int8)}
    for name, counts in got.items():
        n = launches[name] if name in launches else 0
        if counts != {"cluster": n, "single": 0, "plain": 0}:
            fail(f"{what}: {name} launches by design {counts}, want all "
                 f"{n} on the cluster kernel")
    if not got["paged_decode_int8" if int8 else "paged_decode"]["cluster"]:
        fail(f"{what}: no paged-decode launch on the cluster kernel")
    return got


def check_design(fa, what, want_mma):
    """Fail unless every flash launch since the last reset took the bf16
    tensor-core kernels: ``want_mma`` {kernel: launches} of the path."""
    got = {k: dict(v) for k, v in fa.design_launches.items()}
    want = {k: {"mma": want_mma.get(k, 0), "fma": 0} for k in got}
    if got != want:
        fail(f"{what}: flash launches by design {got} != {want} (every "
             f"bf16 flash launch on the tensor-core kernels)")
    return got


# ---------------------------------------------------------------------------
# phase 4: serving at full width
# ---------------------------------------------------------------------------

def build_model(dtype, seed=0, **overrides):
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    cfg = GPTNeoXConfig(param_dtype=dtype, **{**NEOX_125M, **overrides})
    return GPTNeoX(cfg, device="cuda").init_params(seed)


def serve_prompts(cfg, n_req=32):
    """row_serve's prompts (log-normal lengths, 8 to 768 tokens) → (the
    generator after them, the prompts)."""
    rng = np.random.default_rng(0)
    lens = np.clip(np.exp(rng.normal(5.0, 0.8, size=n_req)), 8,
                   768).astype(int)
    return rng, [list(rng.integers(1, cfg.vocab_size, size=int(n)))
                 for n in lens]


def serve(fa, da, report, model=None, key="serve", conf=SERVE_CONFIG,
          monitor=None, check=None):
    """Phase 4 (GPT-NeoX-125M), and with a GPT-2 ``model`` phase 22:
    row_serve's stream of 32 requests x 32 new tokens. Phase 39(c) passes
    a config with a "telemetry" block, a ``monitor`` and ``check(eng)``,
    which holds the engine's observability before it goes and returns
    what it read."""
    from deeperspeed_tpu_torch import InferenceEngine
    model = build_model(torch.bfloat16) if model is None else model
    cfg = model.config
    eng = InferenceEngine(model, config=conf, monitor=monitor)
    n_req, max_new = 32, 32
    rng, prompts = serve_prompts(cfg, n_req)
    warm_buckets(eng, rng, cfg.vocab_size)
    warm = dict(eng.stats)
    torch.cuda.synchronize()

    fa.launches = 0
    fa.reset_design_launches()
    da.launches = 0
    da.reset_launches_by_design()
    prefill_calls = decode_steps = 0
    submit_at, last, seen, itl, ttft = {}, {}, {}, [], []
    submitted = step = 0
    t_start = time.perf_counter()
    while submitted < n_req or eng.scheduler.has_work:
        while submitted < n_req and submitted * 2 <= step:
            rid = eng.submit(prompts[submitted], max_new_tokens=max_new)
            submit_at[rid] = time.perf_counter()
            submitted += 1
        if eng.scheduler.has_work:
            out = eng.step()
            prefill_calls += out["prefilled"] > 0
            decode_steps += out["decoded"] > 0
        now = time.perf_counter()
        for r in list(eng.scheduler.running) + eng.scheduler.finished:
            rid = r.request_id
            if rid not in submit_at:
                continue
            n = len(r.generated)
            if n > seen.get(rid, 0):
                (itl.append(now - last[rid]) if rid in last
                 else ttft.append(now - submit_at[rid]))
                last[rid] = now
                seen[rid] = n
        step += 1
    dt = time.perf_counter() - t_start
    launches = {"flash_fwd": fa.launches, "paged_decode": da.launches}

    done = [r for r in eng.scheduler.finished if r.request_id in submit_at]
    by_id = {r.request_id: r for r in done}
    if len(done) != n_req or any(r.status != "ok" for r in done):
        fail(f"not every request finished ok: "
             f"{[(r.request_id, r.status) for r in done]}")
    if eng.cache.num_free != eng.cache.num_pages - 1:
        fail(f"pages leaked: {eng.cache.num_free} free of "
             f"{eng.cache.num_pages - 1}")
    if any(len(r.generated) != max_new or
           not all(0 <= t < cfg.vocab_size for t in r.generated)
           for r in done):
        fail("a request generated the wrong number of tokens or ids")
    L = cfg.num_layers
    if launches["flash_fwd"] != L * prefill_calls or \
            launches["paged_decode"] != L * decode_steps or \
            not prefill_calls or not decode_steps:
        fail(f"launch counts {launches} != {L} x ({prefill_calls} prefill "
             f"calls, {decode_steps} decode steps)")
    design = check_design(fa, key, {"fwd": launches["flash_fwd"]})
    decode_design = check_decode_design(da, key, launches, False)
    with torch.no_grad():
        logits = model(torch.tensor([prompts[0]], device="cuda"))
    if logits.shape != (1, len(prompts[0]), cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"full forward logits not finite or of shape "
             f"{tuple(logits.shape)}")

    stats = {k: v - warm[k] for k, v in eng.stats.items()
             if isinstance(v, (int, float))}
    gen = sum(len(r.generated) for r in done)

    def pct(vals, q):
        return float(np.percentile(np.asarray(vals), q) * 1e3)

    result = {
        "requests": n_req, "max_new_tokens": max_new,
        "generated_tokens": gen, "wall_s": dt,
        "tokens_per_s": gen / dt, "ttft_p50_ms": pct(ttft, 50),
        "inter_token_p50_ms": pct(itl, 50),
        "inter_token_p99_ms": pct(itl, 99),
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "steps": stats["steps"], "evictions": stats["evictions"],
        "prefill_calls": prefill_calls, "decode_steps": decode_steps,
        "launches": launches, "design_launches": design,
        "decode_design_launches": decode_design["paged_decode"],
        "dtypes": eng.dtypes,
        "tokens": [list(by_id[rid].generated) for rid in submit_at],
    }
    if check is not None:
        result["observability"] = check(eng)
    report[key] = result
    del eng, model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 5: greedy parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def parity(report):
    from deeperspeed_tpu_torch import InferenceEngine
    model = build_model(torch.float32, seed=1)
    cfg = model.config
    rng = np.random.default_rng(1)
    lens = [9, 64, 65, 130, 200, 300, 513, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    model.use_kernels = True
    fast = InferenceEngine(model, config=SERVE_CONFIG).generate(
        prompts, max_new_tokens=16)
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(SERVE_CONFIG))
    plain_cfg["inference"]["kernel"] = "xla"
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    same = [a == b for a, b in zip(fast, plain)]
    report["parity"] = {"prompt_lengths": lens, "identical": same}
    print(f"  parity: {sum(same)}/{len(same)} requests token-identical",
          flush=True)
    if not all(same):
        fail(f"greedy tokens differ between the kernel path and the plain "
             f"path: {fast} vs {plain}")


# ---------------------------------------------------------------------------
# phase 9: serving-quant, the three rungs of row_quant
# ---------------------------------------------------------------------------

def _quant_config(base, weights, kv_dtype):
    conf = json.loads(json.dumps(base))
    if kv_dtype:
        conf["inference"]["kv_cache_dtype"] = kv_dtype
    if weights:
        conf["quantization"] = {"weights": weights}
    return conf


def serve_quant_rung(model, prompts, tag, weights, kv_dtype, fa, da, qm):
    from deeperspeed_tpu_torch import InferenceEngine
    L = model.config.num_layers
    eng = InferenceEngine(model, config=_quant_config(
        QUANT_SERVE_CONFIG, weights, kv_dtype))
    # warm both programs, then measure the decode-heavy stream
    eng.generate([prompts[0]], max_new_tokens=2)
    warm = dict(eng.stats)
    torch.cuda.synchronize()

    fa.launches = da.launches = da.launches_int8 = qm.launches = 0
    qm.reset_design_launches()
    da.reset_launches_by_design()
    prefill_calls = decode_steps = 0
    itl, last = [], {}
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=QUANT_NEW) for p in prompts]
    while eng.scheduler.has_work:
        out = eng.step()
        prefill_calls += out["prefilled"] > 0
        decode_steps += out["decoded"] > 0
        now = time.perf_counter()
        for r in eng.scheduler.running:
            k = len(r.generated)
            prev = last.get(r.request_id)
            if prev is None or prev[0] < k:
                if prev is not None:
                    itl.append(now - prev[1])
                last[r.request_id] = (k, now)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_fwd": fa.launches, "paged_decode": da.launches,
                "paged_decode_int8": da.launches_int8,
                "quant_matmul": qm.launches}

    done = {r.request_id: r for r in eng.scheduler.pop_finished()}
    if sorted(done) != sorted(ids) or any(
            r.status != "ok" or len(r.generated) != QUANT_NEW
            for r in done.values()):
        fail(f"{tag}: not every request finished ok with {QUANT_NEW} "
             f"tokens: {[(i, r.status, len(r.generated)) for i, r in done.items()]}")
    if eng.cache.num_free != eng.cache.num_pages - 1:
        fail(f"{tag}: pages leaked: {eng.cache.num_free} free of "
             f"{eng.cache.num_pages - 1}")
    want = {"flash_fwd": L * prefill_calls,
            "paged_decode": 0 if kv_dtype else L * decode_steps,
            "paged_decode_int8": L * decode_steps if kv_dtype else 0,
            "quant_matmul": (4 * L * (prefill_calls + decode_steps)
                             if weights else 0)}
    if launches != want or not prefill_calls or not decode_steps:
        fail(f"{tag}: launch counts {launches} != {want} ({L} layers, "
             f"{prefill_calls} prefill calls, {decode_steps} decode steps)")
    # every bf16 int8 matmul launch on the path is the wgmma design
    design = dict(qm.design_launches)
    if design != {"wgmma": launches["quant_matmul"], "fma": 0}:
        fail(f"{tag}: int8 matmul launches by design {design}, want all "
             f"{launches['quant_matmul']} on wgmma")
    decode_design = check_decode_design(da, tag, launches, bool(kv_dtype))
    dtok = eng.stats["decode_tokens"] - warm["decode_tokens"]
    dsec = eng.stats["decode_s"] - warm["decode_s"]
    row = {"decode_tok_s": dtok / dsec, "stream_tok_s": dtok / dt,
           "inter_token_p50_ms": float(np.percentile(itl, 50) * 1e3),
           "wall_s": dt, "decode_tokens": dtok, "decode_s": dsec,
           "prefill_s": eng.stats["prefill_s"] - warm["prefill_s"],
           "prefill_calls": prefill_calls, "decode_steps": decode_steps,
           "launches": launches, "quant_matmul_design_launches": design,
           "decode_design_launches": decode_design, "dtypes": eng.dtypes}
    del eng
    torch.cuda.empty_cache()
    return row


def kv_capacity(cfg):
    """row_quant (b): bytes a token holds in the bf16 and the int8 pools
    (scales included) and sessions of 1024 tokens in 1024 MB."""
    from deeperspeed_tpu_torch.inference import PagedKVCache
    pool_mb, sess_tokens = 1024, 1024
    res = {"pool_mb": pool_mb, "session_tokens": sess_tokens}
    for tag, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        c = PagedKVCache(num_layers=cfg.num_layers, num_pages=2,
                         num_heads=cfg.num_heads, page_size=64,
                         head_dim=cfg.head_dim, dtype=dtype, device="cuda")
        res[f"bytes_per_token_{tag}"] = c.bytes_per_token()
        res[f"sessions_{tag}"] = (pool_mb << 20) // (c.bytes_per_token() *
                                                     sess_tokens)
    res["bytes_ratio"] = res["bytes_per_token_bf16"] / \
        res["bytes_per_token_int8"]
    res["capacity_ratio"] = res["sessions_int8"] / res["sessions_bf16"]
    if res["bytes_per_token_int8"] * 128 != res["bytes_per_token_bf16"] * 66:
        fail(f"int8 KV accounting is not 66/128 of bf16 at D = 64: {res}")
    return res


def serve_quant(fa, da, qm, report):
    model = build_model(torch.bfloat16)
    cfg = model.config
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=QUANT_PROMPT))
               for _ in range(QUANT_REQUESTS)]
    rungs = {}
    for tag, weights, kv_dtype in QUANT_RUNGS:
        rungs[tag] = serve_quant_rung(model, prompts, tag, weights,
                                      kv_dtype, fa, da, qm)
    res = {"rungs": rungs, "kv_capacity": kv_capacity(cfg),
           "int8w_decode_vs_bf16": rungs["int8w"]["decode_tok_s"] /
           rungs["bf16"]["decode_tok_s"]}
    report["serve_quant"] = res
    del model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 10: int8 greedy parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def parity_int8(da, qm, report):
    from deeperspeed_tpu_torch import InferenceEngine
    model = build_model(torch.float32, seed=1)
    cfg = model.config
    rng = np.random.default_rng(1)
    lens = [9, 64, 65, 130, 200, 300, 513, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    conf = _quant_config(SERVE_CONFIG, "int8", "int8")
    model.use_kernels = True
    qm.launches = da.launches_int8 = 0
    fast = InferenceEngine(model, config=conf).generate(
        prompts, max_new_tokens=16)
    launched = {"quant_matmul": qm.launches,
                "paged_decode_int8": da.launches_int8}
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(conf))
    plain_cfg["inference"]["kernel"] = "xla"
    qm.launches = da.launches_int8 = 0
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    if qm.launches or da.launches_int8 or not all(launched.values()):
        fail(f"the kernel path launched {launched}, the plain path "
             f"{qm.launches} / {da.launches_int8}")
    same = [a == b for a, b in zip(fast, plain)]
    report["parity_int8"] = {"prompt_lengths": lens, "identical": same,
                             "kernel_launches": launched}
    print(f"  int8 parity: {sum(same)}/{len(same)} requests "
          f"token-identical", flush=True)
    if not all(same):
        fail(f"int8 greedy tokens differ between the kernel path and the "
             f"plain path: {fast} vs {plain}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: training train-125M
# ---------------------------------------------------------------------------

def train(fa, ad, report, profile_step=False, conf=TRAIN_CONFIG, gm=None,
          key="train", steps=TRAIN_STEPS, fall=0.9, fall_last=1,
          on_engine=None):
    """Phase 7, and with ``gm`` (the grouped-matmul module) and the MoE
    config phase 11: the model made MoE by the JSON block alone, with
    the grouped-matmul launches counted too. ``steps`` steps; the least
    of the last ``fall_last`` losses must be below ``fall`` times the
    first. With a
    "quantization.ffn" block (phases 36 and 37) the amax history is held
    to `check_quant_history`."""
    import deeperspeed_tpu_torch as dst
    model = build_model(torch.float32)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    if on_engine is not None:   # phase 39(d) listens to the monitor
        on_engine(eng)
    quant = (conf.get("quantization") or {}).get("ffn")
    if gm is not None and not (
            model.config.moe_num_experts == MOE_BLOCK["num_experts"] and
            model.config.moe_dispatch == MOE_BLOCK["dispatch"] and
            eng.num_params == model.config.num_params() == MOE_NUM_PARAMS):
        fail(f"the moe block did not make the model MoE as configured: "
             f"{model.config}, {eng.num_params} parameters")
    gas = eng.gradient_accumulation_steps()
    micro = eng.train_micro_batch_size_per_gpu()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
    L = model.config.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.reset_design_launches()
    ad.launches = 0
    if gm is not None:
        gm.launches = gm.dw_launches = 0
        gm.reset_design_launches()
    losses, step_s, first_amax = [], [], None
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=(tokens, tokens)))
        step_s.append(time.perf_counter() - t0)
        if quant and step == 0:
            first_amax = eng.quant.amax.clone()
        print(f"  step {step + 1}: loss {losses[-1]:.4f}, "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
                "flash_bwd_dq": fa.bwd_dq_launches, "adam": ad.launches}
    want = {"flash_fwd": L * gas * steps, "flash_bwd_dkv": L * gas * steps,
            "flash_bwd_dq": L * gas * steps, "adam": steps}
    if gm is not None:
        # each layer: two forward products and their two dx products on the
        # forward kernel, two dW products
        launches.update(grouped_matmul=gm.launches,
                        grouped_matmul_dw=gm.dw_launches)
        want.update(grouped_matmul=4 * L * gas * steps,
                    grouped_matmul_dw=2 * L * gas * steps)
    peak = torch.cuda.max_memory_allocated()

    if not all(np.isfinite(losses)):
        fail(f"a training loss is not finite: {losses}")
    if not min(losses[-fall_last:]) < fall * losses[0]:
        fail(f"{key}: the loss did not fall below {fall} x its first: step "
             f"1 {losses[0]:.4f}, the last {fall_last} {losses[-fall_last:]}")
    if launches != want:
        fail(f"{key}: training launch counts {launches} != {want} ({L} "
             f"layers x gas {gas} x {steps} steps, one Adam a step)")
    design = check_design(fa, key, {
        "fwd": launches["flash_fwd"], "dkv": launches["flash_bwd_dkv"],
        "dq": launches["flash_bwd_dq"]})
    if gm is not None:
        # every grouped forward / dx launch on the path is the wgmma design
        design["grouped_matmul"] = dict(gm.design_launches)
        design["grouped_matmul_dw"] = dict(gm.dw_design_launches)
        for name in ("grouped_matmul", "grouped_matmul_dw"):
            if design[name] != {"wgmma": launches[name], "fma": 0}:
                fail(f"{key}: {name} launches by design {design[name]}, "
                     f"want all {launches[name]} on wgmma")
    if eng.global_steps != steps or eng.skipped_steps:
        fail(f"{eng.global_steps} steps taken, {eng.skipped_steps} skipped")
    history = check_quant_history(key, eng, quant, first_amax, gas, steps) \
        if quant else None
    eval_loss = eng.eval_batch((tokens[0], tokens[0]))
    if not np.isfinite(eval_loss):
        fail(f"eval_batch loss {eval_loss} is not finite")

    med = float(np.median(step_s))
    result = {
        "steps": steps, "gas": gas, "micro_batch": micro,
        "seq": TRAIN_SEQ, "losses": losses, "eval_loss": eval_loss,
        "step_ms_median": med * 1e3,
        "step_ms": [t * 1e3 for t in step_s],
        "tokens_per_s": gas * micro * TRAIN_SEQ / med,
        "max_memory_allocated_gb": peak / 2 ** 30,
        "num_params": eng.num_params,
        "launches": launches, "design_launches": design,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "dtypes": {"compute": str(eng.compute_dtype),
                   "master": str(eng._master.dtype)},
        # model flops a token over the bf16 peak (dense only: an MoE
        # step runs top_k of its experts, not all its parameters)
        "mfu": None if model.config.moe_num_experts else
        gas * micro * TRAIN_SEQ / med * neox_ftok(model.config, TRAIN_SEQ) /
        PEAK_FLOPS_S,
    }
    if history is not None:
        result["quant_history"] = history
    if profile_step:
        result["profile"] = profile_window(
            lambda: eng.train_batch(batch=(tokens, tokens)),
            1 if gm is not None else 2, share_of="flash")
    report[key] = result
    del eng, model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8: training parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def train_parity(report, conf=TRAIN_CONFIG, key="train_parity"):
    """Phase 8, and with the MoE config phase 12."""
    import deeperspeed_tpu_torch as dst
    conf = json.loads(json.dumps(conf))
    conf.update(train_batch_size=4, train_micro_batch_size_per_gpu=2,
                gradient_accumulation_steps=2, fp16={"enabled": False})
    # a warm-up floor above 0, so that every one of the 3 steps moves the
    # weights (train-125M's second step runs at lr 0)
    conf["scheduler"]["params"]["warmup_min_lr"] = 6e-5
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(2, 2, TRAIN_SEQ))).cuda()
    losses = {}
    for use_kernels in (True, False):
        model = build_model(torch.float32, seed=1)
        model.use_kernels = use_kernels
        eng, *_ = dst.initialize(model=model, config_params=conf)
        losses[use_kernels] = [eng.train_batch(batch=(tokens, tokens))
                               for _ in range(3)]
        del eng, model
        torch.cuda.empty_cache()
    fast, plain = np.array(losses[True]), np.array(losses[False])
    rel = np.abs(fast - plain) / np.abs(plain)
    report[key] = {"kernels": losses[True], "plain": losses[False],
                   "max_rel_diff": float(rel.max()), "rtol": 1e-4}
    print(f"  losses kernels {losses[True]} vs plain {losses[False]}: max "
          f"relative difference {rel.max():.3e}", flush=True)
    if not (np.isfinite(fast).all() and (rel <= 1e-4).all()):
        fail(f"fp32 training losses differ between the kernel path and the "
             f"plain path beyond rtol 1e-4: {losses}")


# ---------------------------------------------------------------------------
# phase 13: training train-sparse-125M-16k
# ---------------------------------------------------------------------------

def reset_attention_counts(fa, bsa):
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.masked_launches = fa.masked_bwd_dkv_launches = 0
    fa.masked_bwd_dq_launches = 0
    fa.reset_flag_launches()
    fa.reset_design_launches()
    bsa.launches = bsa.dkv_launches = bsa.dq_launches = 0
    bsa.reset_design_launches()


def attention_counts(fa, bsa):
    counts = {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
              "flash_bwd_dq": fa.bwd_dq_launches,
              "flash_masked_fwd": fa.masked_launches,
              "flash_masked_bwd_dkv": fa.masked_bwd_dkv_launches,
              "flash_masked_bwd_dq": fa.masked_bwd_dq_launches,
              "block_sparse_fwd": bsa.launches,
              "block_sparse_dkv": bsa.dkv_launches,
              "block_sparse_dq": bsa.dq_launches}
    for kernel, by_flags in fa.flag_launches.items():
        for flags, n in by_flags.items():
            counts[f"flash_{kernel}_{flags}"] = n
    return counts


def check_sparse_design(bsa, what, launches, design):
    """Fail unless every block-sparse launch since the last reset took
    ``design`` ("mma": the bf16 tensor-core kernels; "fma"), by the
    wrapper's per-kernel counts; ``launches`` is `attention_counts` of
    the same run → {kernel: {design: launches}}."""
    got = {part: dict(counts) for part, counts in
           bsa.design_launches.items()}
    want = {part: {d: launches[f"block_sparse_{part}"] if d == design else 0
                   for d in bsa.DESIGNS} for part in bsa.PARTS}
    if got != want:
        fail(f"{what}: block-sparse launches by design {got} != {want} "
             f"(every launch on the {design} design)")
    return got


def train_sparse(fa, bsa, ad, report, profile_step=False, designs=True,
                 remat=False):
    """Phase 13: GPT-NeoX-125M's widths and depth with an 8192 vocabulary
    at 16,384 tokens, the JSON "sparse_attention" block (fixed l16g1)
    through `initialize()` → `train_batch`, 10 bf16 steps on one repeated
    batch and one `eval_batch`, every attention launch counted: the
    block-sparse arm only, and (with ``designs``) every launch on the
    tensor-core design. With ``remat``, the bench row's remat
    (remat_blocks=True: ``"activation_checkpointing": {"policy":
    "full"}``): each block's forward runs again in the backward, so 24
    block-sparse forward launches a step."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    model = GPTNeoX(GPTNeoXConfig(**SPARSE_MODEL), device="cuda")
    model.init_params(5)
    conf = dict(SPARSE_TRAIN_CONFIG)
    if remat:
        conf["activation_checkpointing"] = {"policy": "full"}
    eng, *_ = dst.initialize(model=model, config_params=conf)
    if remat and model.remat_policy != "full":
        fail(f"the activation_checkpointing block set remat policy "
             f"{model.remat_policy!r}, not 'full'")
    cfg = model.config
    arm = model.sparse_self_attention.arm(SPARSE_SEQ, cfg.head_dim)
    layout = model.sparse_self_attention.get_layout(SPARSE_SEQ)[0]
    density = float(np.asarray(layout, bool).mean())
    if cfg.attention_engine != "sparse" or arm != "block_sparse":
        fail(f"the sparse_attention block did not route train-sparse-125M-16k "
             f"to the block-sparse kernels: engine {cfg.attention_engine}, "
             f"arm {arm}, density {density}")
    micro = eng.train_micro_batch_size_per_gpu()
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, micro, SPARSE_SEQ))).cuda()
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(fa, bsa)
    ad.launches = 0
    losses, step_s = [], []
    for step in range(SPARSE_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=(tokens, tokens)))
        step_s.append(time.perf_counter() - t0)
        print(f"  step {step + 1}: loss {losses[-1]:.4f}, "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    launches = dict(attention_counts(fa, bsa), adam=ad.launches)
    want = {k: 0 for k in launches}
    want.update(block_sparse_fwd=(2 if remat else 1) * L * SPARSE_STEPS,
                block_sparse_dkv=L * SPARSE_STEPS,
                block_sparse_dq=L * SPARSE_STEPS, adam=SPARSE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"a sparse training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the sparse training loss did not fall: step 1 "
             f"{losses[0]:.4f}, step {SPARSE_STEPS} {losses[-1]:.4f}")
    if launches != want:
        fail(f"sparse training launch counts {launches} != {want} ({L} "
             f"layers x {SPARSE_STEPS} steps, no dense or masked flash; "
             f"remat {remat})")
    design = check_sparse_design(bsa, "train-sparse-125M-16k", launches,
                                 "mma") if designs else None
    if eng.global_steps != SPARSE_STEPS or eng.skipped_steps:
        fail(f"{eng.global_steps} steps taken, {eng.skipped_steps} skipped")
    eval_loss = eng.eval_batch((tokens[0], tokens[0]))
    if not np.isfinite(eval_loss):
        fail(f"eval_batch loss {eval_loss} is not finite")
    med = float(np.median(step_s))
    result = {
        "steps": SPARSE_STEPS, "micro_batch": micro, "seq": SPARSE_SEQ,
        "layout": "fixed l16g1 causal", "density": density, "arm": arm,
        "losses": losses, "eval_loss": eval_loss,
        "step_ms_median": med * 1e3, "step_ms": [t * 1e3 for t in step_s],
        "tokens_per_s": micro * SPARSE_SEQ / med,
        "max_memory_allocated_gb": peak / 2 ** 30,
        "num_params": eng.num_params, "launches": launches,
        "design_launches": design,
        "launches_per_step": {k: v / SPARSE_STEPS
                              for k, v in launches.items()},
        "activation_checkpointing": "full" if remat else False,
    }
    if profile_step:
        result["profile"] = profile_window(
            lambda: eng.train_batch(batch=(tokens, tokens)), 1,
            share_of="block_sparse")
    report["train_sparse_remat" if remat else "train_sparse"] = result
    del eng, model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 14: sparse training parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def sparse_parity(fa, bsa, report, key, block, model_kw, seq, micro, gas,
                  arm):
    """3 fp32 steps of a sparse GPT-NeoX through the kernels and 3 through
    the plain versions of the same arm; the losses must agree within rtol
    1e-4, the arm must be ``arm``, and the kernel run must launch that
    arm's kernels and no other attention kernel."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    conf = json.loads(json.dumps(TRAIN_CONFIG))
    conf.update(train_batch_size=micro * gas,
                train_micro_batch_size_per_gpu=micro,
                gradient_accumulation_steps=gas, fp16={"enabled": False},
                sparse_attention=block)
    conf["scheduler"]["params"]["warmup_min_lr"] = 6e-5
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, seq))).cuda()
    losses, counts = {}, {}
    for use_kernels in (True, False):
        model = GPTNeoX(GPTNeoXConfig(**model_kw), device="cuda")
        model.init_params(1)
        model.use_kernels = use_kernels
        eng, *_ = dst.initialize(model=model, config_params=conf)
        got_arm = model.sparse_self_attention.arm(seq,
                                                  model.config.head_dim)
        if got_arm != arm:
            fail(f"{key}: the sparse block took the {got_arm} arm, not {arm}")
        reset_attention_counts(fa, bsa)
        losses[use_kernels] = [eng.train_batch(batch=(tokens, tokens))
                               for _ in range(3)]
        counts[use_kernels] = attention_counts(fa, bsa)
        if use_kernels:
            # fp32: every block-sparse launch keeps the FMA design
            design = check_sparse_design(bsa, key, counts[True], "fma")
        del eng, model
        torch.cuda.empty_cache()
    fast, plain = np.array(losses[True]), np.array(losses[False])
    rel = np.abs(fast - plain) / np.abs(plain)
    prefix = "flash_masked" if arm == "masked_flash" else "block_sparse"
    used = {k: v for k, v in counts[True].items() if v}
    report[key] = {"arm": arm, "seq": seq, "micro": micro, "gas": gas,
                   "kernels": losses[True], "plain": losses[False],
                   "max_rel_diff": float(rel.max()), "rtol": 1e-4,
                   "launches": counts[True], "design_launches": design}
    print(f"  {arm}: losses kernels {losses[True]} vs plain "
          f"{losses[False]}: max relative difference {rel.max():.3e}; "
          f"launches {used}", flush=True)
    if not (np.isfinite(fast).all() and (rel <= 1e-4).all()):
        fail(f"{key}: fp32 sparse training losses differ between the kernel "
             f"path and the plain path beyond rtol 1e-4: {losses}")
    if not used or any(not k.startswith(prefix) for k in used) or \
            any(counts[False].values()):
        fail(f"{key}: the kernel run launched {used}, the plain run "
             f"{counts[False]}; want only the {arm} kernels, and none")
    return report[key]


# ---------------------------------------------------------------------------
# phase 15: training train-bert-large-512
# ---------------------------------------------------------------------------

def bert_batch(gas, micro, seq, vocab, seed=2, ragged=False):
    """bench.py _bert_row's batch (:491-495) as [gas, micro, ...] device
    tensors: ids from numpy rng ``seed``, an all-ones mask (with
    ``ragged``, each row keeps a random prefix), 15% MLM labels, NSP
    labels."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, vocab, (gas, micro, seq), np.int32)
    mask = np.ones((gas, micro, seq), np.float32)
    labels = np.where(r.random((gas, micro, seq)) < 0.15, ids,
                      -1).astype(np.int32)
    nsp = r.integers(0, 2, (gas, micro), np.int32)
    if ragged:
        lens = r.integers(seq // 4, seq + 1, (gas, micro))
        mask = (np.arange(seq) < lens[..., None]).astype(np.float32)
    batch = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
             "attention_mask": mask, "masked_lm_labels": labels,
             "next_sentence_label": nsp}
    return {key: torch.from_numpy(val).cuda() for key, val in batch.items()}


def bert_ftok(cfg, seq):
    """bench.py _bert_row's model flops a token (:502-504)."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    return 6 * (L * 12 * H * H + H * H + H * V) + 12 * L * H * seq


def train_bert(fa, bsa, ad, report, profile_step=False):
    """Phase 15: BERT-large pretraining (bench.py's row_bert512) through
    `initialize()` → `train_batch`, 10 bf16 steps on one batch and one
    `eval_batch`, every attention launch counted: each of the 24 layers
    a step takes the flash forward, dk/dv and dq kernels with both the
    key-bias and dropout flags, and nothing else."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import BertConfig, BertForPreTraining
    cfg = BertConfig.large()
    model = BertForPreTraining(cfg, device="cuda").init_params(1)
    eng, *_ = dst.initialize(model=model, config_params=BERT_TRAIN_CONFIG)
    if not eng.num_params == cfg.num_params() == BERT_NUM_PARAMS:
        fail(f"BERT-large has {eng.num_params} parameters, not "
             f"{BERT_NUM_PARAMS}")
    micro = eng.train_micro_batch_size_per_gpu()
    batch = bert_batch(1, micro, BERT_SEQ, cfg.vocab_size)
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(fa, bsa)
    ad.launches = 0
    losses, step_s = [], []
    for step in range(BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        step_s.append(time.perf_counter() - t0)
        print(f"  step {step + 1}: loss {losses[-1]:.4f}, "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    launches = dict(attention_counts(fa, bsa), adam=ad.launches)
    want = {k: 0 for k in launches}
    want.update({f"flash_{kernel}_kbias_dropout": L * BERT_STEPS
                 for kernel in ("fwd", "dkv", "dq")}, adam=BERT_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"a BERT training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the BERT training loss did not fall: step 1 {losses[0]:.4f}, "
             f"step {BERT_STEPS} {losses[-1]:.4f}")
    if launches != want:
        fail(f"BERT training launch counts {launches} != {want} ({L} layers "
             f"x {BERT_STEPS} steps, flash with the key-bias and dropout "
             f"flags only)")
    design = check_design(fa, "train_bert", {
        kernel: launches[f"flash_{kernel}_kbias_dropout"]
        for kernel in ("fwd", "dkv", "dq")})
    if peak >= 80e9:
        fail(f"BERT training peak memory {peak / 2 ** 30:.2f} GiB")
    if eng.global_steps != BERT_STEPS or eng.skipped_steps:
        fail(f"{eng.global_steps} steps taken, {eng.skipped_steps} skipped")
    eval_loss = eng.eval_batch({k: v[0] for k, v in batch.items()})
    if not np.isfinite(eval_loss):
        fail(f"eval_batch loss {eval_loss} is not finite")
    med = float(np.median(step_s))
    tokens_per_s = micro * BERT_SEQ / med
    result = {
        "steps": BERT_STEPS, "micro_batch": micro, "seq": BERT_SEQ,
        "losses": losses, "eval_loss": eval_loss,
        "step_ms_median": med * 1e3, "step_ms": [t * 1e3 for t in step_s],
        "tokens_per_s": tokens_per_s,
        "model_flops_share": tokens_per_s * bert_ftok(cfg, BERT_SEQ) /
        PEAK_FLOPS_S,
        "max_memory_allocated_gb": peak / 2 ** 30,
        "num_params": eng.num_params, "launches": launches,
        "design_launches": design,
        "launches_per_step": {k: v / BERT_STEPS
                              for k, v in launches.items()},
        "timer_tokens_per_s": eng.tput_timer.avg_tokens_per_sec(),
    }
    if profile_step:
        result["profile"] = profile_window(
            lambda: eng.train_batch(batch=batch), 1, share_of="flash")
    report["train_bert"] = result
    del eng, model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 16: BERT training parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def bert_parity(fa, bsa, report):
    """3 fp32 steps of BERT-large's widths at 4 layers (S 512, micro 2 x
    gas 2, dropout 0.1, a ragged mask) through the kernels and 3 through
    the plain versions, each engine's generator seeded alike, so both
    draw the same dropout masks: the losses must agree within rtol
    1e-4. The first step's gradient (both micro-batches, dropout drawn
    from a generator seeded as the engine's) must agree element by
    element within rtol 1e-4 (atol 1e-4 of its largest magnitude): the
    direct check of dq, dk and dv through the model. The fp32 masters
    after step 3 must agree within atol = rtol = 1e-4, as
    tests/test_torch_bert.py holds them against the JAX engine."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import BertConfig, BertForPreTraining
    cfg = dataclasses.replace(BertConfig.large(), num_layers=4)
    conf = json.loads(json.dumps(BERT_TRAIN_CONFIG))
    conf.update(train_batch_size=4, train_micro_batch_size_per_gpu=2,
                gradient_accumulation_steps=2, fp16={"enabled": False})
    batch = bert_batch(2, 2, BERT_SEQ, cfg.vocab_size, seed=3, ragged=True)
    losses, grads, masters, launches = {}, {}, {}, None
    for use_kernels in (True, False):
        model = BertForPreTraining(cfg, use_kernels=use_kernels,
                                   device="cuda").init_params(7)
        eng, *_ = dst.initialize(model=model, config_params=conf)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        loss = sum(model.loss_fn(model.params_tree(),
                                 {k: v[i] for k, v in batch.items()},
                                 rng=gen) for i in range(2)) / 2
        grads[use_kernels] = torch.cat([
            g.reshape(-1) for g in torch.autograd.grad(
                loss, list(model.parameters()))])
        reset_attention_counts(fa, bsa)
        losses[use_kernels] = [eng.train_batch(batch=batch)
                               for _ in range(3)]
        masters[use_kernels] = eng._master.detach().clone()
        if use_kernels:
            launches = attention_counts(fa, bsa)
        del eng, model
        torch.cuda.empty_cache()
    fast, plain = np.array(losses[True]), np.array(losses[False])
    rel = np.abs(fast - plain) / np.abs(plain)
    g_diff = (grads[True] - grads[False]).abs()
    g_max = float(grads[False].abs().max())
    g_off = int((g_diff > 1e-4 * (g_max + grads[False].abs())).sum())
    diff = (masters[True] - masters[False]).abs()
    n_off = int((diff > 1e-4 + 1e-4 * masters[False].abs()).sum())
    n = cfg.num_layers * 2 * 3
    report["train_bert_parity"] = {"kernels": losses[True],
                                   "plain": losses[False],
                                   "max_rel_diff": float(rel.max()),
                                   "rtol": 1e-4,
                                   "grad_max_abs_diff": float(g_diff.max()),
                                   "grad_max_abs": g_max,
                                   "grads_outside_tol": g_off,
                                   "master_max_abs_diff": float(diff.max()),
                                   "masters_outside_tol": n_off,
                                   "master_atol_rtol": 1e-4,
                                   "launches": launches}
    print(f"  losses kernels {losses[True]} vs plain {losses[False]}: max "
          f"relative difference {rel.max():.3e}; step-1 gradient max abs "
          f"difference {float(g_diff.max()):.3e} of max {g_max:.3e}, "
          f"{g_off} outside tolerance; masters max abs difference "
          f"{float(diff.max()):.3e}, {n_off} outside atol = rtol = 1e-4",
          flush=True)
    flagged = {f"flash_{kernel}_kbias_dropout": n
               for kernel in ("fwd", "dkv", "dq")}
    if any(launches[k] != v for k, v in flagged.items()):
        fail(f"BERT parity run launched {launches}, not {n} flagged flash "
             f"forward, dk/dv and dq calls each")
    if not (np.isfinite(fast).all() and (rel <= 1e-4).all()):
        fail(f"fp32 BERT training losses differ between the kernel path and "
             f"the plain path beyond rtol 1e-4: {losses}")
    if g_off or not torch.isfinite(grads[True]).all():
        fail(f"{g_off} elements of the fp32 step-1 gradient differ between "
             f"the kernel path and the plain path beyond rtol 1e-4 (max abs "
             f"difference {float(g_diff.max()):.3e} of max {g_max:.3e})")
    if n_off or not torch.isfinite(masters[True]).all():
        fail(f"{n_off} fp32 masters differ between the kernel path and the "
             f"plain path after 3 steps beyond atol = rtol = 1e-4 (max abs "
             f"difference {float(diff.max()):.3e})")
    return report["train_bert_parity"]


# ---------------------------------------------------------------------------
# phase 17: checkpoint save / resume of train-125M
# ---------------------------------------------------------------------------

def ckpt_snapshot(eng):
    """Device copies of every field a checkpoint restores."""
    return {"master": eng._master.clone(),
            "params": eng._params_flat.clone(),
            "exp_avg": eng.opt_state.exp_avg.clone(),
            "exp_avg_sq": eng.opt_state.exp_avg_sq.clone(),
            "scalars": ckpt_scalars(eng)}


def ckpt_scalars(eng):
    return {"adam_step": eng.opt_state.step, "lr": eng.get_lr(),
            "lr_iteration": eng.lr_scheduler.last_batch_iteration,
            "loss_scale": tuple(eng.scale_state),
            "global_steps": eng.global_steps,
            "global_samples": eng.global_samples,
            "micro_steps": eng.micro_steps,
            "skipped_steps": eng.skipped_steps}


def ckpt_restored(eng, snap, what):
    """Fail unless every field equals its value at the save, bit for
    bit."""
    tensors = {"master": eng._master, "params": eng._params_flat,
               "exp_avg": eng.opt_state.exp_avg,
               "exp_avg_sq": eng.opt_state.exp_avg_sq}
    off = [k for k, t in tensors.items() if not torch.equal(t, snap[k])]
    if off or ckpt_scalars(eng) != snap["scalars"]:
        fail(f"{what}: restored state differs from the save: tensors "
             f"{off}, scalars {ckpt_scalars(eng)} vs {snap['scalars']}")


def train_checkpoint(fa, ad, report):
    """Phase 17 on train-125M: (a) 6 steps, a sync save, 4 steps; a
    fresh engine from other weights loads and takes the same 4 steps
    through the counted kernels; (b) an async save overlapped with
    steps (bench.py row_ckpt's quantities); (c) a corrupted newest
    checkpoint falls back to the previous one, and naming it raises;
    (d) the shipped zero_to_fp32.py gives back the masters. Checkpoints
    go to a temporary directory under build/, removed at the end."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.checkpoint import manifest as mf
    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir="build")
    try:
        return _train_checkpoint(dst, mf, fa, ad, report, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_checkpoint(dst, mf, fa, ad, report, tmp):
    eng, *_ = dst.initialize(model=build_model(torch.float32),
                             config_params=TRAIN_CONFIG)
    gas = eng.gradient_accumulation_steps()
    micro = eng.train_micro_batch_size_per_gpu()
    L = NEOX_125M["num_layers"]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()

    def steps(engine, n):
        losses, times = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(batch=(tokens, tokens)))
            times.append(time.perf_counter() - t0)
        return losses, times

    # (a) save and resume
    _, step_s = steps(eng, CKPT_STEPS_BEFORE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save_checkpoint(tmp)
    sync_s = time.perf_counter() - t0
    first_tag = f"global_step{CKPT_STEPS_BEFORE}"
    sync_bytes = sum(e["bytes"] for e in mf.load_manifest(
        os.path.join(tmp, first_tag))["files"].values())
    snap = ckpt_snapshot(eng)
    whole, _ = steps(eng, CKPT_STEPS_AFTER)

    resumed, *_ = dst.initialize(model=build_model(torch.float32, seed=1),
                                 config_params=TRAIN_CONFIG)
    if torch.equal(resumed._master, snap["master"]):
        fail("the fresh engine starts from the saved weights")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, _ = resumed.load_checkpoint(tmp)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if path != os.path.join(tmp, first_tag):
        fail(f"load_checkpoint resumed {path}, want {first_tag}")
    ckpt_restored(resumed, snap, "load_checkpoint")
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.reset_design_launches()
    ad.launches = 0
    after, _ = steps(resumed, CKPT_STEPS_AFTER)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
                "flash_bwd_dq": fa.bwd_dq_launches, "adam": ad.launches}
    want = {"flash_fwd": L * gas * CKPT_STEPS_AFTER,
            "flash_bwd_dkv": L * gas * CKPT_STEPS_AFTER,
            "flash_bwd_dq": L * gas * CKPT_STEPS_AFTER,
            "adam": CKPT_STEPS_AFTER}
    if launches != want:
        fail(f"resumed steps' launch counts {launches} != {want}")
    design = check_design(fa, "train_ckpt", {
        "fwd": want["flash_fwd"], "dkv": want["flash_bwd_dkv"],
        "dq": want["flash_bwd_dq"]})
    whole_a, after_a = np.array(whole), np.array(after)
    rel = np.abs(after_a - whole_a) / np.abs(whole_a)
    identical = bool(np.array_equal(after_a, whole_a))
    print(f"  resumed losses {after} vs uninterrupted {whole}: max relative "
          f"difference {rel.max():.3e}, bit-identical {identical}",
          flush=True)
    if not (np.isfinite(after_a).all() and (rel <= 1e-4).all()):
        fail(f"resumed losses {after} differ from the uninterrupted run's "
             f"{whole} beyond rtol 1e-4")
    del resumed
    torch.cuda.empty_cache()

    # (b) async save, overlapped with steps (bench.py row_ckpt)
    manager = eng.checkpoint_manager
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    async_tag = eng.save_checkpoint_async(tmp)
    async_s = time.perf_counter() - t0
    overlapped = 0
    while manager.in_flight and overlapped < 64:
        eng.train_batch(batch=(tokens, tokens))
        overlapped += 1
    torch.cuda.synchronize()
    manager.wait()
    if manager.saves_completed != 1 or mf.read_latest(tmp) != async_tag:
        fail(f"the async save {async_tag} did not commit "
             f"({manager.saves_completed} saves, latest "
             f"{mf.read_latest(tmp)})")
    step_ms = float(np.median(step_s[1:])) * 1e3

    # (c) the newest checkpoint corrupted: fall back; named, it raises
    zero = os.path.join(tmp, async_tag,
                        "zero_pp_rank_0_mp_rank_00_optim_states.pt")
    with open(zero, "r+b") as f:
        f.seek(os.path.getsize(zero) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    path, _ = eng.load_checkpoint(tmp)
    if path != os.path.join(tmp, first_tag):
        fail(f"with {async_tag} corrupted, load_checkpoint() resumed {path}, "
             f"want the previous committed {first_tag}")
    ckpt_restored(eng, snap, "the fallback load")
    try:
        eng.load_checkpoint(tmp, tag=async_tag)
    except RuntimeError as e:
        raised = str(e)
    else:
        fail(f"loading the corrupted {async_tag} by name did not raise")

    # the disk alone: 1 GiB of raw bytes written and fsynced beside the
    # checkpoints
    raw = os.path.join(tmp, "disk_probe.bin")
    block = np.random.default_rng(0).bytes(1 << 30)
    t0 = time.perf_counter()
    with open(raw, "wb") as f:
        f.write(block)
        f.flush()
        os.fsync(f.fileno())
    disk_mb_s = 1024 / (time.perf_counter() - t0)
    os.remove(raw)
    del block

    # (d) the shipped recovery script gives back the masters
    out = os.path.join(tmp, "fp32.pt")
    ckpt = os.path.join(tmp, first_tag)
    res = subprocess.run([sys.executable, os.path.join(ckpt, "zero_to_fp32.py"),
                          ckpt, out], capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        fail(f"zero_to_fp32.py failed: {res.stderr[-2000:]}")
    sd = torch.load(out, weights_only=False)
    fp32 = torch.cat([torch.from_numpy(sd[n.replace(".", "/")]).reshape(-1)
                      for n in eng.param_names])
    if len(sd) != len(eng.param_names) or \
            not torch.equal(fp32, snap["master"].cpu()):
        fail("zero_to_fp32.py's fp32 state dict differs from the masters")
    del sd, fp32

    result = {
        "steps_before": CKPT_STEPS_BEFORE, "steps_after": CKPT_STEPS_AFTER,
        "losses_uninterrupted": whole, "losses_resumed": after,
        "max_rel_diff": float(rel.max()), "rtol": 1e-4,
        "bit_identical": identical, "launches": launches,
        "design_launches": design,
        "ckpt_step_ms": step_ms,
        "ckpt_sync_stall_ms": sync_s * 1e3,
        "ckpt_async_stall_ms": async_s * 1e3,
        "ckpt_async_overlap_steps": overlapped,
        "ckpt_bytes_mb": manager.total_bytes / 2 ** 20,
        "ckpt_stall_ratio": async_s / sync_s,
        "sync_bytes_mb": sync_bytes / 2 ** 20,
        "sync_write_mb_s": sync_bytes / 2 ** 20 / sync_s,
        "async_write_s": manager.total_write_s,
        "async_write_mb_s": manager.total_bytes / 2 ** 20 /
        manager.total_write_s,
        "load_s": load_s, "disk_write_mb_s": disk_mb_s,
        "fallback": {"corrupted": async_tag, "resumed": first_tag,
                     "named_load_raised": raised[:200]},
        "zero_to_fp32": "equal to the masters",
    }
    report["train_ckpt"] = result
    del eng, snap
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phases 3, 18, 19: packed documents at 16,384 tokens
# ---------------------------------------------------------------------------

def packed_rows(seq, rows=2):
    """row_packed's data: the seeded document mixture (documents capped
    at ``seq``) packed into ``seq``-token rows, the first ``rows`` of
    them → (tokens [rows, seq] int64, segment ids [rows, seq] int32) on
    the host."""
    from deeperspeed_tpu_torch.runtime.packing import (pack_documents,
                                                       synthetic_doc_mixture)
    docs = synthetic_doc_mixture(
        PACKED_DOCS["seed"], PACKED_DOCS["n_docs"],
        PACKED_DOCS["vocab_size"], mean_len=PACKED_DOCS["mean_len"],
        sigma=PACKED_DOCS["sigma"], max_len=seq)
    tok, seg = pack_documents(docs, seq)
    if tok.shape[0] < rows:
        fail(f"the mixture packed into {tok.shape[0]} rows < {rows}")
    return tok[:rows].astype(np.int64), seg[:rows]


def check_packed_at_scale(fa, q, k, v, seg, out, lse, do, delta, heads=2):
    """The segmented flash forward (``out``, ``lse``) and one backward
    launch on (``do``, ``delta``) at phase 18's shape and rows against
    their plain versions, run on one (batch row, ``heads`` heads) slice
    at a time: heads are independent, and one head's fp32 scores at
    16,384 tokens are about 1.07 GB where the whole would be about 26 GB.
    → (max abs errors of out, lse, dq, dk, dv over all slices, ok under
    TOL / TOL_BWD)."""
    B, S, H, D = q.shape
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, seg)
    lse3 = lse.view(B, H, S)
    tol = {"out": TOL[q.dtype]["out"], "lse": TOL[q.dtype]["lse"],
           **{n: TOL_BWD[q.dtype] for n in ("dq", "dk", "dv")}}
    errs, ok = dict.fromkeys(tol, 0.0), True
    for b in range(B):
        for h in range(0, H, heads):
            sl = (slice(b, b + 1), slice(None), slice(h, h + heads))
            qs, ks, vs, os_, dos = (x[sl] for x in (q, k, v, out, do))
            ls = lse3[b, h:h + heads].contiguous()
            ref_o, ref_l = fa.flash_attention_segmented_reference(
                qs, ks, vs, seg[b:b + 1])
            pairs = [("out", os_, ref_o), ("lse", ls, ref_l)]
            pairs += zip(("dq", "dk", "dv"), (x[sl] for x in (dq, dk, dv)),
                         fa.flash_attention_bwd_reference(
                             qs, ks, vs, os_, ls, dos, seg[b:b + 1]))
            for name, got, want in pairs:
                err, good = close(got, want, *tol[name])
                errs[name] = max(errs[name], err)
                ok = ok and good
            del pairs, ref_o, ref_l
    del dq, dk, dv
    torch.cuda.empty_cache()
    return errs, ok


def check_packed_attention(fa, gen, report):
    """Phase 3 for the segmented flash kernels on packed rows: forward
    and backward against their plain versions at S 4096 (bf16 and fp32,
    phase 19(a)'s segments) and at phase 18's attention shape (B=2
    S=16384 H=12 D=64 bf16, its rows; `check_packed_at_scale`), then
    timed there beside SDPA (forward, and its backward) under the same
    bool mask; the bound counts the live (causal, same-document) pairs.
    The plain version is timed at S 4096 only: at 16,384 it would
    materialize about 26 GB of fp32 scores at once."""
    import torch.nn.functional as F
    H, D = SPARSE_MODEL["num_heads"], \
        SPARSE_MODEL["hidden_size"] // SPARSE_MODEL["num_heads"]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        _, seg_np = packed_rows(PACKED_PARITY_SEQ)
        seg = torch.from_numpy(seg_np).cuda()
        B, S = seg.shape
        q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
        out, lse = fa.flash_attention_cuda(q, k, v, seg)
        ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v,
                                                                  seg)
        err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
        err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
        del ref_out, ref_lse
        grow, ok_g, (o, l_, do_, _) = check_grads(fa, q, k, v, seg, gen)
        row = {"B": B, "S": S, "H": H, "D": D, "dtype": str(dtype),
               "segments": "packed", "max_abs_err_out": err_o,
               "max_abs_err_lse": err_l, "tol_out": TOL[dtype]["out"],
               "tol_bwd": TOL_BWD[dtype], **grow}
        if dtype == torch.bfloat16:
            row["plain_fwd_ms"] = time_ms(
                lambda: fa.flash_attention_segmented_reference(q, k, v, seg),
                warmup=1, iters=3)
            row["plain_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, o, l_, do_,
                                                         seg),
                warmup=1, iters=3)
        print(f"  flash packed (S {S}) {row}", flush=True)
        if not (ok_o and ok_l and ok_g):
            fail(f"segmented flash kernels disagree with their plain "
                 f"versions on packed rows: {row}")
        rows.append(row)
        del q, k, v, out, lse, o, l_, do_
        torch.cuda.empty_cache()
    # the timings at phase 18's shape
    _, seg_np = packed_rows(PACKED_SEQ)
    seg = torch.from_numpy(seg_np).cuda()
    B, S = seg.shape
    q, k, v, _, _ = prefill_case(S, torch.bfloat16, gen, B=B, H=H, D=D)
    out, lse = fa.flash_attention_cuda(q, k, v, seg)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(q.dtype)
    delta = fa.attention_delta(out, do)
    errs, ok = check_packed_at_scale(fa, q, k, v, seg, out, lse, do, delta)
    print(f"  flash packed (S {S}, phase 18's rows) max abs errors {errs}",
          flush=True)
    if not ok:
        fail(f"segmented flash kernels disagree with their plain versions "
             f"at phase 18's shape and rows: {errs}")
    t = {"B": B, "S": S, "H": H, "D": D, "dtype": str(q.dtype),
         "segments": "packed (phase 18's rows)",
         **{f"max_abs_err_{n}": e for n, e in errs.items()},
         "tol_out": TOL[q.dtype]["out"], "tol_lse": TOL[q.dtype]["lse"],
         "tol_bwd": TOL_BWD[q.dtype],
         "live_pairs": live_pairs(seg, B, S),
         "causal_pairs": B * S * (S + 1) // 2,
         "plain": f"not timed at S {S} (about 26 GB of fp32 scores); "
                  f"plain_fwd_ms / plain_bwd_ms are S {PACKED_PARITY_SEQ}'s"}
    t["fwd_ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v, seg))
    t["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, lse, do, delta, seg))
    t["causal_fwd_ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v))
    t["fwd_bound_ms"], t["fwd_bound_by"] = prefill_bound_ms(q, seg)
    t["bwd_bound_ms"], t["bwd_bound_by"] = flash_bwd_bound_ms(q, seg)
    t["plain_fwd_ms"] = rows[0]["plain_fwd_ms"]
    t["plain_bwd_ms"] = rows[0]["plain_bwd_ms"]
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None] & \
        (seg[:, :, None] == seg[:, None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    with torch.no_grad():
        t["library_fwd_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None]), warmup=2, iters=10)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                           attn_mask=mask[:, None])
    do_t = do.transpose(1, 2).contiguous()
    t["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True), warmup=2, iters=10)
    t["library"] = "SDPA under the same bool mask [B, 1, S, S]"
    print(f"  flash packed times (B={B} S={S}, {t['live_pairs']} live pairs "
          f"of {t['causal_pairs']} causal): forward {t['fwd_ms']:.4f} ms "
          f"(causal without segments {t['causal_fwd_ms']:.4f}), backward "
          f"{t['bwd_ms']:.4f} ms; SDPA {t['library_fwd_ms']:.4f} / "
          f"{t['library_bwd_ms']:.4f} ms; bound {t['fwd_bound_ms']:.5f} / "
          f"{t['bwd_bound_ms']:.5f} ms ({t['fwd_bound_by']} / "
          f"{t['bwd_bound_by']})", flush=True)
    report["flash_packed"] = {"checks": rows, "times": t}
    del q, k, v, out, lse, do, delta, mask, qt, kt, vt, o_lib, do_t
    torch.cuda.empty_cache()
    return t


def release_cublas_workspaces():
    """Free the cuBLAS workspaces PyTorch keeps, one for every (handle,
    stream) pair that ran a cuBLAS call (it frees none by itself; the next
    call allocates its stream's again) → bytes released, None where the
    build lacks the call."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        return None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    clear()
    return before - torch.cuda.memory_allocated()


def memory_census(top=8):
    """What holds device memory before phase 18 builds an engine: the
    CUDA tensors Python can reach (gc), grouped by (shape, dtype), the
    ``top`` largest groups; the allocator's live blocks by size; then
    the cuBLAS workspaces released (`release_cublas_workspaces`) →
    {"allocated_gb",
    "reachable_gb", "groups", "blocks_mb", "cublas_workspaces_gb",
    "after_gb"}."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    groups, seen = {}, set()
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), st.nbytes())
        except Exception:
            continue
        if key in seen:
            continue
        seen.add(key)
        g = groups.setdefault((tuple(obj.shape), str(obj.dtype)), [0, 0])
        g[0] += 1
        g[1] += key[1]
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                mb = b["size"] / 2 ** 20
                blocks[mb] = blocks.get(mb, 0) + 1
    allocated = torch.cuda.memory_allocated()
    released = release_cublas_workspaces()
    after = torch.cuda.memory_allocated()
    return {"allocated_gb": allocated / 2 ** 30,
            "reachable_gb": sum(n for _, n in groups.values()) / 2 ** 30,
            "groups": [{"shape": list(shape), "dtype": dtype, "count": c,
                        "gb": n / 2 ** 30}
                       for (shape, dtype), (c, n) in rows[:top]],
            "blocks_mb": {f"{mb:g}": c for mb, c in
                          sorted(blocks.items(), key=lambda kv: -kv[0])[:top]},
            "cublas_workspaces_gb": None if released is None
            else released / 2 ** 30,
            "after_gb": after / 2 ** 30}


def packed_run(fa, bsa, ad, tokens, seg, policy, steps, eval_too=False,
               profile_step=False):
    """One engine of phase 18 from seed-5 weights: ``steps`` bf16
    `train_batch` steps on the packed batch (no segment ids, and no
    "packing" block, when ``seg`` is None) under remat ``policy``, every
    attention and Adam launch counted and checked: per step 12 flash
    forward launches (24 where the policy recomputes the forward:
    full, dots, offload_dots), 12 dk/dv, 12 dq, all on the tensor-core
    design, no other attention kernel, one Adam. Its peak memory is
    read above what was allocated before the engine was built, each run
    starting with the cuBLAS workspaces released, so every run counts
    the workspaces it allocates itself."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    conf = json.loads(json.dumps(PACKED_TRAIN_CONFIG))
    conf["activation_checkpointing"] = {"policy": policy}
    if seg is None:
        del conf["packing"]
    release_cublas_workspaces()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    model = GPTNeoX(GPTNeoXConfig(**SPARSE_MODEL), device="cuda") \
        .init_params(5)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    if model.config.use_segment_ids != (seg is not None) or \
            model.remat_policy != policy:
        fail(f"phase 18's config did not reach the model: use_segment_ids "
             f"{model.config.use_segment_ids}, remat {model.remat_policy}")
    batch = (tokens, tokens) if seg is None else (tokens, tokens, seg)
    L = model.config.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(fa, bsa)
    ad.launches = 0
    losses, step_s = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        step_s.append(time.perf_counter() - t0)
        print(f"  {policy}{'' if seg is not None else ', no segments'} step "
              f"{step + 1}: loss {losses[-1]:.4f}, {step_s[-1] * 1e3:.1f} ms",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(attention_counts(fa, bsa), adam=ad.launches)
    fwd = 2 if policy in ("full", "dots", "offload_dots") else 1
    want = {k: 0 for k in launches}
    want.update(flash_fwd=fwd * L * steps, flash_bwd_dkv=L * steps,
                flash_bwd_dq=L * steps, adam=steps)
    if launches != want:
        fail(f"phase 18 ({policy}, segments {seg is not None}) launch "
             f"counts {launches} != {want}")
    design = check_design(fa, f"train_packed ({policy})", {
        "fwd": want["flash_fwd"], "dkv": want["flash_bwd_dkv"],
        "dq": want["flash_bwd_dq"]})
    if not all(np.isfinite(losses)):
        fail(f"a phase 18 loss is not finite ({policy}): {losses}")
    if eng.global_steps != steps or eng.skipped_steps:
        fail(f"{eng.global_steps} steps taken, {eng.skipped_steps} skipped")
    med = float(np.median(step_s))
    run = {"policy": policy, "segments": seg is not None, "steps": steps,
           "losses": losses, "step_ms": [x * 1e3 for x in step_s],
           "step_ms_median": med * 1e3,
           "tokens_per_s": tokens.numel() / med,
           "max_memory_allocated_gb": peak / 2 ** 30,
           "baseline_gb": baseline / 2 ** 30,
           "peak_gb": (peak - baseline) / 2 ** 30,
           "launches": launches, "design_launches": design,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "num_params": eng.num_params}
    if eval_too:
        run["eval_loss"] = eng.eval_batch(tuple(x[0] for x in batch))
        if not np.isfinite(run["eval_loss"]):
            fail(f"eval_batch loss {run['eval_loss']} is not finite")
    if profile_step:
        run["profile"] = profile_window(lambda: eng.train_batch(batch=batch),
                                        1, share_of="flash")
    del eng, model
    torch.cuda.empty_cache()
    return run


def train_packed(fa, bsa, ad, report, profile_step=False):
    """Phase 18: train-packed-125M-16k (bench.py's row_packed on one
    card). The main run: 10 steps and one `eval_batch` on 2 packed rows
    of 16,384 tokens under "full" remat, the loss falling. Beside it, at
    the same shape: the no-segment control (row_packed's: the same
    tokens without segment ids or the packing block, still "full"), the
    no-remat run ("none") and 3 steps each under dots, attn_residuals
    and offload_dots. Every policy's 3 losses must equal the "none"
    run's bit for bit (the recompute is the same arithmetic); peak
    memory must order full < none, attn_residuals <= dots <= none and
    offload_dots < dots."""
    from deeperspeed_tpu_torch.runtime.packing import (
        count_effective_targets, packed_batch_token_stats)
    tok_np, seg_np = packed_rows(PACKED_SEQ)
    eff, total = packed_batch_token_stats((tok_np[None], tok_np[None],
                                           seg_np[None]))
    if eff != count_effective_targets(seg_np):
        fail("the packed batch's token stats disagree")
    tokens = torch.from_numpy(tok_np[None]).cuda()
    seg = torch.from_numpy(seg_np[None]).cuda()
    docs_in_rows = [int(np.unique(r[r > 0]).size) for r in seg_np]
    survivors = memory_census()
    print(f"  device memory held before phase 18: "
          f"{survivors['allocated_gb']:.4f} GiB allocated, "
          f"{survivors['reachable_gb']:.4f} GiB in reachable tensors "
          f"(largest {survivors['groups'][:2]}), live blocks by MiB "
          f"{survivors['blocks_mb']}; cuBLAS workspaces released "
          f"{survivors['cublas_workspaces_gb']} GiB, "
          f"{survivors['after_gb']:.4f} GiB left", flush=True)
    runs = {"full": packed_run(fa, bsa, ad, tokens, seg, "full",
                               PACKED_STEPS, eval_too=True,
                               profile_step=profile_step)}
    main = runs["full"]
    if not main["losses"][-1] < main["losses"][0]:
        fail(f"the packed training loss did not fall: step 1 "
             f"{main['losses'][0]:.4f}, step {PACKED_STEPS} "
             f"{main['losses'][-1]:.4f}")
    control = packed_run(fa, bsa, ad, tokens, None, "full", PACKED_STEPS)
    for policy in ("none", "dots", "attn_residuals", "offload_dots"):
        runs[policy] = packed_run(fa, bsa, ad, tokens, seg, policy,
                                  PACKED_POLICY_STEPS)
    base = runs["none"]["losses"]
    equal = {p: r["losses"][:PACKED_POLICY_STEPS] == base
             for p, r in runs.items()}
    peak = {p: r["peak_gb"] for p, r in runs.items()}
    result = {
        "seq": PACKED_SEQ, "rows": int(tok_np.shape[0]),
        "documents_per_row": docs_in_rows,
        "occupancy": float((seg_np != 0).mean()),
        "effective_targets": eff, "total_targets": total,
        "effective_fraction": eff / total,
        "steps": PACKED_STEPS, "losses": main["losses"],
        "eval_loss": main["eval_loss"],
        "step_ms_median": main["step_ms_median"],
        "tokens_per_s": main["tokens_per_s"],
        "effective_tokens_per_s": main["tokens_per_s"] * eff / total,
        "noseg_step_ms_median": control["step_ms_median"],
        "noseg_tokens_per_s": control["tokens_per_s"],
        "seg_speedup": control["step_ms_median"] / main["step_ms_median"],
        "remat_cost_ms": main["step_ms_median"] -
        runs["none"]["step_ms_median"],
        "peak_gb": peak, "noseg_peak_gb": control["peak_gb"],
        "baseline_gb": {p: r["baseline_gb"] for p, r in runs.items()},
        "survivors": survivors,
        "losses_equal_none": equal, "launches": main["launches"],
        "design_launches": main["design_launches"],
        "launches_per_step": main["launches_per_step"],
        "runs": runs, "noseg": control}
    report["train_packed"] = result
    for p, r in runs.items():
        print(f"  {p}: median step {r['step_ms_median']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak memory "
              f"{r['peak_gb']:.3f} GiB above the {r['baseline_gb']:.3f} GiB "
              f"held before the engine, flash launches a "
              f"step {r['launches_per_step']['flash_fwd']:.0f} / "
              f"{r['launches_per_step']['flash_bwd_dkv']:.0f} / "
              f"{r['launches_per_step']['flash_bwd_dq']:.0f}, losses "
              f"{r['losses'][:PACKED_POLICY_STEPS]} (equal to none: "
              f"{equal[p]})", flush=True)
    bad = [p for p, same in equal.items() if not same]
    if bad:
        fail(f"remat policies {bad} change the losses: "
             f"{ {p: runs[p]['losses'][:PACKED_POLICY_STEPS] for p in runs} }")
    if not (peak["full"] < peak["none"] and
            peak["attn_residuals"] <= peak["dots"] <= peak["none"] and
            peak["offload_dots"] < peak["dots"]):
        fail(f"peak memory out of order (want full < none, attn_residuals "
             f"<= dots <= none, offload_dots < dots): {peak}")
    return result


def packed_parity(fa, bsa, report):
    """Phase 19(a): phase 18's model at 4 layers, S 4096, micro 2, fp32,
    the packing block and "full" remat: 3 steps through the kernels and
    3 through the plain versions; the losses must agree within rtol
    1e-4, and the kernel run takes 8 flash forward (the recompute),
    4 dk/dv and 4 dq launches a step, all on the FMA design (fp32)."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    conf = json.loads(json.dumps(PACKED_TRAIN_CONFIG))
    conf["fp16"] = {"enabled": False}
    cfg = GPTNeoXConfig(**dict(SPARSE_MODEL, num_layers=4,
                               max_seq_len=PACKED_PARITY_SEQ))
    tok_np, seg_np = packed_rows(PACKED_PARITY_SEQ)
    batch = (torch.from_numpy(tok_np[None]).cuda(),) * 2 + \
        (torch.from_numpy(seg_np[None]).cuda(),)
    losses, launches, design = {}, None, None
    for use_kernels in (True, False):
        model = GPTNeoX(cfg, use_kernels=use_kernels, device="cuda") \
            .init_params(9)
        eng, *_ = dst.initialize(model=model, config_params=conf)
        reset_attention_counts(fa, bsa)
        losses[use_kernels] = [eng.train_batch(batch=batch)
                               for _ in range(3)]
        if use_kernels:
            launches = attention_counts(fa, bsa)
            design = {k: dict(v) for k, v in fa.design_launches.items()}
        del eng, model
        torch.cuda.empty_cache()
    fast, plain = np.array(losses[True]), np.array(losses[False])
    rel = np.abs(fast - plain) / np.abs(plain)
    L = cfg.num_layers
    want = {k: 0 for k in launches}
    want.update(flash_fwd=2 * L * 3, flash_bwd_dkv=L * 3, flash_bwd_dq=L * 3)
    report["train_packed_parity"] = {
        "kernels": losses[True], "plain": losses[False],
        "max_rel_diff": float(rel.max()), "rtol": 1e-4, "seq": cfg.max_seq_len,
        "launches": launches, "design_launches": design}
    print(f"  (a) GPT-NeoX 4 layers, S {PACKED_PARITY_SEQ}, packed, full "
          f"remat: losses kernels {losses[True]} vs plain {losses[False]}: "
          f"max relative difference {rel.max():.3e}", flush=True)
    if launches != want:
        fail(f"packed parity launch counts {launches} != {want}")
    if design != {k: {"mma": 0, "fma": want[f"flash_{n}"]} for k, n in
                  (("fwd", "fwd"), ("dkv", "bwd_dkv"), ("dq", "bwd_dq"))}:
        fail(f"packed parity launches by design {design}: fp32 takes the "
             f"FMA kernels")
    if not (np.isfinite(fast).all() and (rel <= 1e-4).all()):
        fail(f"fp32 packed training losses differ between the kernel path "
             f"and the plain path beyond rtol 1e-4: {losses}")
    return report["train_packed_parity"]


def bert_packed_parity(fa, bsa, report):
    """Phase 19(b): BERT-large's widths at 4 layers, fp32, S 512, 2 packed
    rows, hidden dropout 0.1 and attention dropout 0, number_checkpoints
    2 ("full" spans of 2 layers): `encode(segment_ids=)` takes the
    non-causal segmented flash kernels. The loss (a fixed projection of
    the encoder output) and its gradient through the kernels and through
    the plain versions, dropout from generators seeded alike: the loss
    within rtol 1e-4, the gradient element by element within rtol 1e-4
    (atol 1e-4 of its largest magnitude); 8 flash forward (the recompute),
    4 dk/dv and 4 dq launches, no flagged one."""
    from deeperspeed_tpu_torch import BertConfig, BertModel
    from deeperspeed_tpu_torch.runtime.packing import (pack_documents,
                                                       synthetic_doc_mixture)
    cfg = dataclasses.replace(BertConfig.large(), num_layers=4,
                              attn_dropout=0.0)
    S = BERT_PACKED_SEQ
    docs = synthetic_doc_mixture(3, 32, cfg.vocab_size, mean_len=128.0,
                                 sigma=1.0, max_len=S)
    ids, seg = (torch.from_numpy(a[:2]).cuda()
                for a in pack_documents(docs, S))
    proj = torch.randn(2, S, cfg.hidden_size, device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(4))
    losses, grads, launches = {}, {}, None
    for use_kernels in (True, False):
        model = BertModel(cfg, number_checkpoints=2, use_kernels=use_kernels,
                          device="cuda").init_params(7)
        params = model.params_tree()
        reset_attention_counts(fa, bsa)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        out = model.encode(params, ids, rng=gen, deterministic=False,
                           segment_ids=seg)
        loss = (out * proj).sum() / out.numel()
        named = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith("pooler")]
        g = torch.autograd.grad(loss, [p for _, p in named])
        if use_kernels:
            launches = attention_counts(fa, bsa)
        losses[use_kernels] = float(loss.detach())
        grads[use_kernels] = torch.cat([x.reshape(-1) for x in g])
        del model, params, out, loss, g
        torch.cuda.empty_cache()
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    g_diff = (grads[True] - grads[False]).abs()
    g_max = float(grads[False].abs().max())
    g_off = int((g_diff > 1e-4 * (g_max + grads[False].abs())).sum())
    L = cfg.num_layers
    want = {k: 0 for k in launches}
    want.update(flash_fwd=2 * L, flash_bwd_dkv=L, flash_bwd_dq=L)
    report["bert_packed_parity"] = {
        "kernels": losses[True], "plain": losses[False],
        "rel_diff": rel, "grad_max_abs_diff": float(g_diff.max()),
        "grad_max_abs": g_max, "grads_outside_tol": g_off, "rtol": 1e-4,
        "launches": launches,
        "documents_per_row": [int(np.unique(r[r > 0]).size)
                              for r in seg.cpu().numpy()]}
    print(f"  (b) BERT-large widths, 4 layers, S {S}, packed, 2 spans: loss "
          f"kernels {losses[True]:.8f} vs plain {losses[False]:.8f} "
          f"(relative {rel:.3e}); gradient max abs difference "
          f"{float(g_diff.max()):.3e} of max {g_max:.3e}, {g_off} outside "
          f"tolerance; launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    if launches != want:
        fail(f"BERT packed parity launch counts {launches} != {want} (the "
             f"non-causal segmented flash on every layer, twice forward)")
    if not (np.isfinite(losses[True]) and rel <= 1e-4):
        fail(f"BERT packed loss differs between the kernel path and the "
             f"plain path beyond rtol 1e-4: {losses}")
    if g_off or not torch.isfinite(grads[True]).all():
        fail(f"{g_off} elements of the BERT packed gradient differ between "
             f"the kernel path and the plain path beyond rtol 1e-4")
    return report["bert_packed_parity"]


def packed_times(t, part):
    """The kernels line's entry for the segmented flash ``part`` ("fwd",
    "bwd") at phase 18's shape (`check_packed_attention`)."""
    errs = {n: t[f"max_abs_err_{n}"] for n in
            (("out", "lse") if part == "fwd" else ("dq", "dk", "dv"))}
    tol = ({"out": t["tol_out"], "lse": t["tol_lse"]} if part == "fwd"
           else t["tol_bwd"])
    return {"ms": t[f"{part}_ms"], "plain_ms": t[f"plain_{part}_ms"],
            "library_ms": t[f"library_{part}_ms"],
            "max_abs_err": errs, "tol": tol,
            "bound_ms": t[f"{part}_bound_ms"],
            "bound_by": t[f"{part}_bound_by"], "live_pairs": t["live_pairs"],
            "shape": f"B={t['B']} S={t['S']} H={t['H']} D={t['D']} bf16, "
                     f"causal, packed documents (phase 18's rows)",
            "plain": t["plain"], "library": t["library"]}


def print_packed(tp, card):
    full, none = tp["runs"]["full"], tp["runs"]["none"]
    print(f"  {tp['steps']} steps (full remat): loss {tp['losses'][0]:.4f} "
          f"-> {tp['losses'][-1]:.4f} (eval {tp['eval_loss']:.4f}), median "
          f"step {tp['step_ms_median']:.1f} ms, {tp['tokens_per_s']:.0f} "
          f"tokens/s, {tp['effective_tokens_per_s']:.0f} effective tokens/s "
          f"(fraction {tp['effective_fraction']:.4f}, occupancy "
          f"{tp['occupancy']:.4f}, documents a row "
          f"{tp['documents_per_row']}); no-segment control "
          f"{tp['noseg_step_ms_median']:.1f} ms (seg/no-seg speed-up "
          f"{tp['seg_speedup']:.3f}); no remat {none['step_ms_median']:.1f} "
          f"ms (remat cost {tp['remat_cost_ms']:.1f} ms); peak memory "
          f"{ {p: round(v, 3) for p, v in tp['peak_gb'].items()} } GiB "
          f"above what the engine found allocated (full "
          f"{full['baseline_gb']:.3f} GiB) on {card}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 6 (--profile): where a serving step's time goes
# ---------------------------------------------------------------------------

def profile_window(fn, steps, share_of=None, also=()):
    """Run ``fn`` ``steps`` times under the profiler: host ms per step,
    device kernel ms per step, busy share, launches per step and the
    kernels that take the most device time; with ``share_of``, the share
    of device time (and the ms a step) of the kernels whose names hold
    it, and the same for each name fragment in ``also``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        us = getattr(e, "device_time", None)
        us = e.cuda_time if us is None else us
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + us, n + 1)
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    extra = {}
    for part in ((share_of,) if share_of is not None else ()) + tuple(also):
        us = sum(t for name, (t, _) in by_name.items() if part in name)
        extra["device_share_" + part] = us / max(busy_us, 1e-9)
        extra["device_ms_per_step_" + part] = us / 1e3 / steps
    return {**extra,
        "steps": steps,
        "host_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": (busy_us / 1e6) / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": n / steps}
                        for name, (t, n) in top],
    }


def print_profile(name, res, card):
    print(f"  {name}: host {res['host_ms_per_step']:.3f} ms/step, "
          f"device {res['device_ms_per_step']:.3f} ms/step, busy share "
          f"{res['device_busy_share']:.3f}, "
          f"{res['kernel_launches_per_step']:.0f} launches/step on "
          f"{card}", flush=True)
    for k in res["top_kernels"][:6]:
        print(f"      {k['ms_per_step']:.4f} ms "
              f"x{k['launches_per_step']:.0f}  {k['name']}", flush=True)


def profile(report, card):
    from deeperspeed_tpu_torch import InferenceEngine
    model = build_model(torch.bfloat16)
    cfg = model.config
    eng = InferenceEngine(model, config=SERVE_CONFIG)
    rng = np.random.default_rng(0)
    eng.generate([list(rng.integers(1, cfg.vocab_size, size=b - 2))
                  for b in eng.prefill_lengths], max_new_tokens=2)
    # a full decode batch: 16 requests of 200-300 prompt tokens
    for n in rng.integers(200, 300, size=16):
        eng.submit(list(rng.integers(1, cfg.vocab_size, size=int(n))),
                   max_new_tokens=200)
    while eng.scheduler.waiting:
        eng.step()
    eng.step()
    decode = profile_window(eng.step, 20, share_of="paged_decode")
    # one prefill call at the B=4, S=512 bucket, through the engine's
    # device program
    S = 512
    tokens = torch.randint(1, cfg.vocab_size, (4, S), device="cuda")
    lengths = torch.tensor([S, 400, 300, 200], dtype=torch.int32,
                           device="cuda")
    table = torch.zeros((4, S // eng.page_size), dtype=torch.int32,
                        device="cuda")
    prefill = profile_window(lambda: eng._prefill(tokens, lengths, table), 5,
                             share_of="flash")
    report["profile"] = {"decode_B16": decode, "prefill_B4_S512": prefill}
    print_profile("decode step (B=16)", decode, card)
    print(f"  paged decode: {decode['device_ms_per_step_paged_decode']:.4f} "
          f"ms a step", flush=True)
    print_profile("prefill call (B=4, S=512)", prefill, card)
    print(f"  flash kernels' share of device time: "
          f"{prefill['device_share_flash']:.3f}", flush=True)
    del eng
    # a decode window of each serve-quant rung, mid-stream (16 sequences of
    # 62 prompt tokens, all prefilled)
    for tag, weights, kv_dtype in QUANT_RUNGS:
        eng = InferenceEngine(model, config=_quant_config(
            QUANT_SERVE_CONFIG, weights, kv_dtype))
        for _ in range(QUANT_REQUESTS):
            eng.submit(list(rng.integers(1, cfg.vocab_size,
                                         size=QUANT_PROMPT)),
                       max_new_tokens=QUANT_NEW)
        while eng.scheduler.waiting:
            eng.step()
        eng.step()
        res = profile_window(eng.step, 10, share_of="paged_decode")
        report["profile"][f"decode_quant_{tag}"] = res
        print_profile(f"serve-quant decode step ({tag})", res, card)
        print(f"  paged decode: {res['device_ms_per_step_paged_decode']:.4f} "
              f"ms a step", flush=True)
        del eng
    del model
    torch.cuda.empty_cache()


def gmm_shape(row):
    return (f"R=20480 (8 spans of {GMM_SPAN}, {sum(GMM_SIZES)} live rows) "
            f"K={row['K']} N={row['N']} bf16")


DECODE_DESIGN = (
    "bf16 and int8 pools at D 64/128: split-KV over a thread-block cluster "
    "of min(8, pages a row) CTAs halved to fit one wave, pages dealt "
    "round-robin, empty ranks exit at once, 16-byte cp.async page tiles "
    "in a 2-stage ring, fixed-order DSMEM merge in rank 0; fp32 pools and "
    "D 256: one block a (sequence, head)")
DECODE_GRAPH_KEYS = ("graph_ms", "warm_graph_ms", "parent_graph_ms",
                     "parent_warm_graph_ms", "plain_graph_ms",
                     "library_graph_ms", "library_warm_graph_ms",
                     "layers_cycled", "cluster", "cluster8_graph_ms")


def decode_graph_times(row):
    """A timed decode row's CUDA-graph times: cold (cycling layers) and
    warm, of the kernel, the parent's single-block kernel, the plain
    version and SDPA."""
    return {k: row[k] for k in DECODE_GRAPH_KEYS if k in row}


def decode_shape_row(row):
    return {k: row[k] for k in (
        "shape", "lengths_drawn", "max_abs_err", "ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by")} | decode_graph_times(row)


def graph_times(row):
    """The CUDA-graph device times of a small kernel's row (the int8
    matmul at decode rows)."""
    return {k: row[k] for k in ("graph_ms", "plain_graph_ms",
                                "library_graph_ms")}


def decode_only(tree, card):
    """Phase 3's paged-decode checks and timings alone, on the port of
    the checkout ``tree`` (this one, or another commit's, to time its
    kernels by the same cold method on the same card in the same call)."""
    sys.path.insert(0, os.path.abspath(tree))
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    report = {"card": card, "tree": os.path.abspath(tree),
              "decode_attention": da.__file__}
    print("paged decode vs plain versions:", flush=True)
    for int8 in (False, True):
        check_decode(da, report, int8=int8)
    print(json.dumps({"decode": {k: report[k] for k in (
        "paged_decode", "paged_decode_int8")}}), flush=True)
    print(f"decode-only on {card}: {report['tree']}", flush=True)
    return 0


def print_checkpoint(tc, card):
    print(f"  checkpoint train-125M: {tc['steps_before']} steps, save, "
          f"{tc['steps_after']} resumed steps bit-identical "
          f"{tc['bit_identical']} (max relative difference "
          f"{tc['max_rel_diff']:.3e}), launches {tc['launches']}; "
          f"step {tc['ckpt_step_ms']:.1f} ms, sync stall "
          f"{tc['ckpt_sync_stall_ms']:.1f} ms, async stall "
          f"{tc['ckpt_async_stall_ms']:.1f} ms (ratio "
          f"{tc['ckpt_stall_ratio']:.4f}), {tc['ckpt_async_overlap_steps']} "
          f"steps overlapped, {tc['ckpt_bytes_mb']:.1f} MB a save, write "
          f"{tc['sync_write_mb_s']:.0f} MB/s sync / "
          f"{tc['async_write_mb_s']:.0f} MB/s async (the disk alone "
          f"{tc['disk_write_mb_s']:.0f} MB/s), load {tc['load_s']:.2f} s on "
          f"{card}", flush=True)
    print(json.dumps({"row_ckpt": {k: tc[k] for k in (
        "ckpt_step_ms", "ckpt_sync_stall_ms", "ckpt_async_stall_ms",
        "ckpt_async_overlap_steps", "ckpt_bytes_mb", "ckpt_stall_ratio")},
        "load_s": tc["load_s"], "sync_write_mb_s": tc["sync_write_mb_s"],
        "async_write_mb_s": tc["async_write_mb_s"],
        "disk_write_mb_s": tc["disk_write_mb_s"]}), flush=True)
    return tc


def ckpt_only(tree, card):
    """Phase 17 alone, on the port of the checkout ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    print("checkpoint train-125M (bf16, fp32 masters, ZeRO-2):", flush=True)
    print_checkpoint(train_checkpoint(fa, ad, {}), card)
    print(f"ckpt-only on {card}: {os.path.abspath(tree)}", flush=True)
    return 0


def sparse_only(tree, card):
    """Phase 13 alone, its step profiled, on the port of the checkout
    ``tree`` (this one, or another commit's, to time the sparse training
    step of both on the same card in the same call). Its launch counts
    and falling loss are checked; its launches by design are not, since
    another commit's port may not count them."""
    sys.path.insert(0, os.path.abspath(tree))
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    report = {"card": card, "tree": os.path.abspath(tree)}
    ts = train_sparse(fa, bsa, ad, report, profile_step=True, designs=False)
    print(f"  {ts['steps']} steps: loss {ts['losses'][0]:.4f} -> "
          f"{ts['losses'][-1]:.4f}, median step {ts['step_ms_median']:.1f} "
          f"ms, {ts['tokens_per_s']:.0f} tokens/s", flush=True)
    print_profile("sparse training step (micro 2 x 16384, l16g1)",
                  ts["profile"], card)
    print(f"  block-sparse kernels' share of device time: "
          f"{ts['profile']['device_share_block_sparse']:.3f}", flush=True)
    print(json.dumps({"train_sparse": {k: ts[k] for k in (
        "step_ms_median", "step_ms", "tokens_per_s", "losses",
        "profile")}}), flush=True)
    print(f"sparse-only on {card}: {report['tree']}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 3 (continued): flat Adam at GPT-2 XL's size, lean and classic
# ---------------------------------------------------------------------------

def adam_xl_case(gen, n, lean):
    """The inputs of one flat Adam call at n elements: lean (bf16 p, g, m,
    v) or classic (fp32 p, m, v, bf16 g, a bf16 copy)."""
    pdt = torch.bfloat16 if lean else torch.float32
    p = torch.randn(n, generator=gen, device="cuda", dtype=pdt)
    g = torch.randn(n, generator=gen, device="cuda", dtype=torch.bfloat16)
    m = torch.randn(n, generator=gen, device="cuda", dtype=pdt).mul_(0.1)
    v = torch.rand(n, generator=gen, device="cuda", dtype=pdt).mul_(0.01)
    return p, g, m, v


def adam_xl_run(ad, case, lean):
    """One kernel call on copies of ``case`` → (p, m, v, bf16 copy or
    None)."""
    p, g, m, v = case
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    out = None if lean else torch.empty(p.numel(), dtype=torch.bfloat16,
                                        device="cuda")
    ad.adam_cuda(pk, g, mk, vk, 6e-4, 3, adam_w=True, bias_correction=True,
                 p_out=out, **ADAM_XL_HP)
    torch.cuda.synchronize()
    return pk, mk, vk, out


def check_adam_xl(ad, gen, report):
    """Phase 3 at GPT-2 XL's 1,557,686,400 elements: the lean variant
    (bf16 p, g, m, v) and the classic one (fp32 p, m, v, bf16 g and the
    bf16 copy), each held against the plain version chunk by chunk: p, m
    and v bit-equal to it (the kernel rounds each operation where the
    plain version does), two calls bit-identical, timed (CUDA events) beside the plain version (chunk
    by chunk) and `torch.optim.AdamW(fused=True)` on one flat parameter
    of the same storage (bf16 with bf16 state; fp32), the library
    yardstick."""
    n = GPT2_XL_PARAMS
    rows = {}
    for lean in (True, False):
        tag = "lean" if lean else "classic"
        case = adam_xl_case(gen, n, lean)
        first = adam_xl_run(ad, case, lean)
        second = adam_xl_run(ad, case, lean)
        identical = all(torch.equal(a, b) for a, b in zip(first[:3],
                                                          second[:3]))
        if not lean:
            identical = identical and torch.equal(first[3], second[3])
        del second
        p, g, m, v = case
        errs, exact, recast = {"p": 0.0, "m": 0.0, "v": 0.0}, True, True
        for lo in range(0, n, ADAM_XL_CHUNK):
            hi = min(n, lo + ADAM_XL_CHUNK)
            want = ad.adam_flat_reference(p[lo:hi], g[lo:hi], m[lo:hi],
                                          v[lo:hi], 6e-4, 3, adam_w=True,
                                          bias_correction=True,
                                          **ADAM_XL_HP)
            for name, got, ref in zip("pmv", first, want):
                errs[name] = max(errs[name], float(
                    (got[lo:hi].float() - ref.float()).abs().max()))
                exact = exact and torch.equal(got[lo:hi], ref)
            if not lean:
                recast = recast and torch.equal(
                    first[3][lo:hi], first[0][lo:hi].to(torch.bfloat16))
            del want
        del first
        torch.cuda.empty_cache()
        row = {"n": n, "variant": tag,
               "dtypes": {"p": str(p.dtype), "g": str(g.dtype),
                          "m_v": str(m.dtype)},
               **{f"max_abs_err_{k}": e for k, e in errs.items()},
               "two_calls_identical": identical, "bit_equal_plain": exact,
               "tol": "bit-equal"}
        if not lean:
            row["bf16_copy_is_recast"] = recast
        print(f"  adam n={n} ({tag}): errors {errs}, bit-equal to the plain "
              f"version {exact}, two calls identical {identical}" +
              ("" if lean else f", recast {recast}"), flush=True)
        if not (exact and identical and recast):
            fail(f"flat Adam kernel ({tag}, n={n}) is not bit-equal to its "
                 f"plain version or to itself: {row}")
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        out = None if lean else torch.empty(n, dtype=torch.bfloat16,
                                            device="cuda")
        row["ms"] = time_ms(lambda: ad.adam_cuda(
            pk, g, mk, vk, 6e-4, 3, adam_w=True, bias_correction=True,
            p_out=out, **ADAM_XL_HP), warmup=3, iters=15)
        del pk, mk, vk, out

        def plain():
            for lo in range(0, n, ADAM_XL_CHUNK):
                hi = min(n, lo + ADAM_XL_CHUNK)
                ad.adam_flat_reference(p[lo:hi], g[lo:hi], m[lo:hi],
                                       v[lo:hi], 6e-4, 3, adam_w=True,
                                       bias_correction=True, **ADAM_XL_HP)
        row["plain_ms"] = time_ms(plain, warmup=1, iters=3)
        # the library yardstick: fused AdamW on one flat parameter, its
        # grad in the parameter's dtype, its state in the same dtype
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.to(p.dtype)
        del case, p, m, v
        torch.cuda.empty_cache()
        lib = torch.optim.AdamW([lib_p], lr=6e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.01, fused=True)
        row["library_ms"] = time_ms(lib.step, warmup=3, iters=15)
        row["library"] = f"torch.optim.AdamW(fused=True), {tag} storage"
        del lib_p, lib, g
        torch.cuda.empty_cache()
        # each input read once, each output written once
        nbytes = n * (14 if lean else 3 * 8 + 2 + 2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 14 * n)
        print(f"  adam times n={n} ({tag}): kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
        rows[tag] = row
    report["adam_xl"] = rows
    return rows


def check_gpt2_attention(fa, da, gen, report):
    """Phase 3 at GPT-2 XL's attention shapes, whose 25 heads no earlier
    check takes: the bf16 flash forward, dk/dv and dq at phase 20's
    training shape (B=8 S=1024 H=25 D=64, causal), the forward at phase
    22's prefill shape (B=4 S=1024, ragged segments) and the paged decode
    at phase 22's decode geometry (B=16 H=25 D=64 ps=64 NP=16 P=513,
    bf16 pools), each against its plain version within TOL / TOL_BWD
    (length-0 rows exact zeros, two decode calls bit-identical), every
    launch on the design the GPT-2 phases take (the tensor-core flash,
    the cluster decode). The training-shape kernels are timed beside
    SDPA, the library yardstick."""
    import torch.nn.functional as F
    bf16 = torch.bfloat16
    H = GPT2_XL["num_heads"]
    D = GPT2_XL["hidden_size"] // H
    B = GPT2_RUNGS[0][1]
    fa.reset_design_launches()
    da.reset_launches_by_design()
    q, k, v, _, _ = prefill_case(GPT2_SEQ, bf16, gen, B=B, H=H, D=D)
    bwd, ok_b, (out, lse, do, delta) = check_grads(fa, q, k, v, None, gen)
    ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v)
    err_o, ok_o = close(out, ref_out, *TOL[bf16]["out"])
    err_l, ok_l = close(lse, ref_lse, *TOL[bf16]["lse"])
    del ref_out, ref_lse
    fwd = {"shape": f"B={B} S={GPT2_SEQ} H={H} D={D} bf16, causal",
           "max_abs_err_out": err_o, "max_abs_err_lse": err_l,
           "tol_out": TOL[bf16]["out"], "tol_lse": TOL[bf16]["lse"]}
    bwd = {"shape": fwd["shape"] + " (dkv + dq kernels)",
           "tol": TOL_BWD[bf16], **bwd}
    pq, pk, pv, seg, _ = prefill_case(GPT2_SEQ, bf16, gen, B=4, H=H, D=D)
    p_out, p_lse = fa.flash_attention_cuda(pq, pk, pv, seg)
    ref_out, ref_lse = fa.flash_attention_segmented_reference(pq, pk, pv,
                                                              seg)
    err_po, ok_po = close(p_out, ref_out, *TOL[bf16]["out"])
    err_pl, ok_pl = close(p_lse, ref_lse, *TOL[bf16]["lse"])
    prefill = {"shape": f"B=4 S={GPT2_SEQ} H={H} D={D} bf16, ragged "
                        f"segments", "max_abs_err_out": err_po,
               "max_abs_err_lse": err_pl, "tol_out": TOL[bf16]["out"]}
    del pq, pk, pv, seg, p_out, p_lse, ref_out, ref_lse
    geo = dict(B=16, H=H, D=D, ps=64, NP=16, P=513)
    dq_, table, lengths = decode_query_case(bf16, gen, **geo)
    pools = decode_pools(gen, 2, geo["P"], H, geo["ps"], D, bf16, False)
    views = tuple(p[1] for p in pools)
    d_out = decode_call(da, dq_, views, table, lengths)
    again = decode_call(da, dq_, views, table, lengths)
    ref = decode_reference(da, dq_, views, table, lengths)
    torch.cuda.synchronize()
    err_d, ok_d = close(d_out, ref, *TOL[bf16]["out"])
    zero_ok = bool((d_out[lengths == 0] == 0).all())
    same = torch.equal(d_out, again)
    decode = {"shape": "B={B} H={H} D={D} ps={ps} NP={NP} P={P} bf16 "
                       "pools".format(**geo),
              "lengths_drawn": "0-{0} with 0, {1}, {0}, {2}".format(
                  geo["NP"] * geo["ps"], geo["ps"], 3 * geo["ps"]),
              "max_abs_err": err_d, "tol": TOL[bf16]["out"],
              "zero_rows_exact": zero_ok, "two_calls_identical": same,
              "cluster": da.launch_plan(geo["B"], H, geo["NP"])}
    del pools, views, d_out, again, ref
    designs = {"flash": check_design(fa, "phase 3 (GPT-2 XL shapes)",
                                     {"fwd": 2, "dkv": 1, "dq": 1}),
               "decode": dict(da.launches_by_design)}
    if designs["decode"] != {"cluster": 2, "single": 0, "plain": 0}:
        fail(f"phase 3 (GPT-2 XL shapes): paged-decode launches by design "
             f"{designs['decode']}, want both on the cluster kernel")
    for name, row in (("flash_fwd", fwd), ("flash_bwd", bwd),
                      ("flash_fwd (prefill)", prefill),
                      ("paged_decode", decode)):
        print(f"  {name} at GPT-2 XL's shape {row}", flush=True)
    if not (ok_o and ok_l and ok_b and ok_po and ok_pl and ok_d and
            zero_ok and same):
        fail(f"a kernel disagrees with its plain version at GPT-2 XL's "
             f"shapes: {fwd}, {bwd}, {prefill}, {decode}")
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    fwd["ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v))
    bwd["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, lse, do, delta))
    with torch.no_grad():
        fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2).contiguous()
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    fwd["bound_ms"], fwd["bound_by"] = prefill_bound_ms(q, None)
    bwd["bound_ms"], bwd["bound_by"] = flash_bwd_bound_ms(q, None)
    for name, r in (("flash_fwd", fwd), ("flash_bwd", bwd)):
        print(f"  {name} times at GPT-2 XL's shape: kernel {r['ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    del q, k, v, out, lse, do, delta, qt, kt, vt, o_lib, do_t
    torch.cuda.empty_cache()
    rows = {"flash_fwd": fwd, "flash_bwd": bwd, "prefill": prefill,
            "paged_decode": decode, "design_launches": designs}
    report["gpt2xl_attention"] = rows
    return rows


# ---------------------------------------------------------------------------
# phases 20-23: the GPT-2 family (GPT-2 XL, bench.py's row_gpt2xl)
# ---------------------------------------------------------------------------

def gpt2_tree(cfg, seed):
    """Seeded weights made by the port (`gpt2.init_params`) on the card."""
    from deeperspeed_tpu_torch.models import gpt2
    return gpt2.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")


def gpt2_conf(bs, lean, micro=None, gas=1):
    """row_gpt2xl's DeepSpeed config (bench.py:572-590): the lean state
    (bf16 parameters as masters, bf16 Adam moments) or the classic one
    (fp32 masters and moments), bf16 compute, ZeRO stage 0."""
    fp16 = {"enabled": True, "type": "bfloat16"}
    opt = {"lr": 1e-4}
    if lean:
        fp16["fp16_master_weights_and_grads"] = True
        opt["state_dtype"] = "bfloat16"
    conf = {"train_batch_size": bs, "steps_per_print": 10_000,
            "optimizer": {"type": "Adam", "params": opt}, "fp16": fp16,
            "zero_optimization": {"stage": 0}}
    if micro is not None:
        conf.update(train_micro_batch_size_per_gpu=micro,
                    gradient_accumulation_steps=gas)
    return conf


def gpt2_tokens(bs, gas=1, seed=4):
    """row_gpt2xl's tokens: default_rng(4) ids below the vocabulary,
    shaped [gas, bs / gas, 1024]; labels equal tokens."""
    r = np.random.default_rng(seed)
    tok = r.integers(0, GPT2_XL["vocab_size"], (gas, bs // gas, GPT2_SEQ),
                     np.int64)
    return torch.from_numpy(tok).cuda()


def gpt2_engine(tree, conf, policy, cfg=None, use_kernels=True):
    """A GPT-2 engine from ``tree`` through `initialize(model=,
    model_parameters=)`; ``policy`` None is whole-block remat (the
    row's floor), else the named remat policy."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPT2, GPT2Config
    cfg = cfg or GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16)
    model = GPT2(cfg, device="cuda", use_kernels=use_kernels,
                 remat_blocks=policy is None, remat_policy=policy)
    eng, *_ = dst.initialize(model=model, model_parameters=tree,
                             config_params=conf)
    return eng, model


def gpt2_step_launches(L, steps, fwd_per_layer, micro_steps=1):
    """The launches of ``steps`` training steps by design: per micro-step
    L flash forward (2L where the policy recomputes it), L dk/dv, L dq,
    and one Adam a step."""
    mu = steps * micro_steps
    return dict(flash_fwd=fwd_per_layer * L * mu, flash_bwd_dkv=L * mu,
                flash_bwd_dq=L * mu, adam=steps)


def gpt2_launch_check(fa, bsa, ad, what, want, lean):
    """Exact launches since the last reset: ``want`` {flash_fwd,
    flash_bwd_dkv, flash_bwd_dq, adam}, every flash launch on the
    tensor-core design, no other attention kernel, and every Adam launch
    on the lean or the fp32 variant → (launches, designs, Adam launches
    by variant)."""
    launches = dict(attention_counts(fa, bsa), adam=ad.launches)
    full = dict.fromkeys(launches, 0) | want
    if launches != full:
        fail(f"{what}: launch counts {launches} != {full}")
    design = check_design(fa, what, {"fwd": want["flash_fwd"],
                                     "dkv": want["flash_bwd_dkv"],
                                     "dq": want["flash_bwd_dq"]})
    variant = "lean" if lean else "fp32"
    if dict(ad.variant_launches) != {variant: want["adam"]}:
        fail(f"{what}: Adam launches by variant {ad.variant_launches}, "
             f"want {{{variant!r}: {want['adam']}}}")
    return launches, design, dict(ad.variant_launches)


def train_gpt2xl_rung(fa, bsa, ad, tree, tag, bs, policy, lean,
                      profile_step=False):
    """One rung of phase 20: 2 warm-up and 3 timed bf16 `train_batch`
    steps of GPT-2 XL at micro ``bs`` x 1024 under ``policy``; with
    ``profile_step`` one more step under the profiler."""
    release_cublas_workspaces()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng, model = gpt2_engine(tree, gpt2_conf(bs, lean), policy)
    if eng.num_params != GPT2_XL_PARAMS or eng.keep_master == lean or \
            (eng._master.dtype == torch.float32) == lean or \
            eng.opt_state.exp_avg.dtype != (torch.bfloat16 if lean
                                            else torch.float32):
        fail(f"phase 20 ({tag}): the engine's state is not the "
             f"{'lean' if lean else 'classic'} one: {eng.num_params} "
             f"parameters, master {eng._master.dtype}, moments "
             f"{eng.opt_state.exp_avg.dtype}")
    init_peak = torch.cuda.max_memory_allocated()
    tokens = gpt2_tokens(bs)
    L = model.config.num_layers
    losses, step_s = [], []
    for step in range(GPT2_WARMUP + GPT2_STEPS):
        if step == GPT2_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_attention_counts(fa, bsa)
            ad.reset_launches()
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=(tokens, tokens)))
        step_s.append(time.perf_counter() - t0)
        print(f"  {tag} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    fwd = 2 if policy in (None, "full", "dots") else 1
    launches, design, variants = gpt2_launch_check(
        fa, bsa, ad, f"phase 20 ({tag})",
        gpt2_step_launches(L, GPT2_STEPS, fwd), lean)
    if not all(np.isfinite(losses)):
        fail(f"a phase 20 loss is not finite ({tag}): {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase 20 ({tag}): the loss did not fall: {losses}")
    if eng.global_steps != GPT2_WARMUP + GPT2_STEPS or eng.skipped_steps:
        fail(f"{eng.global_steps} steps taken, {eng.skipped_steps} skipped")
    med = float(np.median(step_s[GPT2_WARMUP:]))
    tps = bs * GPT2_SEQ / med
    run = {"rung": tag, "batch": bs, "policy": policy or "full (whole "
           "block)", "state": "lean" if lean else "classic",
           "losses": losses, "step_ms": [x * 1e3 for x in step_s],
           "step_ms_median": med * 1e3, "tokens_per_s": tps,
           "gpt2_xl_1p5b_mfu": tps * GPT2_FTOK / PEAK_FLOPS_S,
           "baseline_gb": baseline / 2 ** 30,
           "peak_gb": (peak - baseline) / 2 ** 30,
           "init_peak_gb": (init_peak - baseline) / 2 ** 30,
           "state_gb": (eng._master.numel() * eng._master.element_size() +
                        (0 if eng._params_flat is eng._master else
                         eng._params_flat.numel() * 2) +
                        eng._grads_flat.numel() * 2 +
                        (0 if eng._grad_acc is eng._grads_flat else
                         eng._grad_acc.numel() * 4) +
                        2 * eng.opt_state.exp_avg.numel() *
                        eng.opt_state.exp_avg.element_size()) / 2 ** 30,
           "launches": launches, "design_launches": design,
           "adam_variants": variants,
           "launches_per_step": {k: v / GPT2_STEPS
                                 for k, v in launches.items() if v}}
    print(f"  {tag}: median step {run['step_ms_median']:.1f} ms, "
          f"{tps:.0f} tokens/s, MFU {run['gpt2_xl_1p5b_mfu']:.4f}, peak "
          f"{run['peak_gb']:.2f} GiB above {run['baseline_gb']:.2f} "
          f"(state {run['state_gb']:.2f}), launches per step "
          f"{run['launches_per_step']}", flush=True)
    if profile_step:
        run["profile"] = profile_window(
            lambda: eng.train_batch(batch=(tokens, tokens)), 1,
            share_of="flash", also=("adam_kernel", "nvjet"))
    del eng, model
    torch.cuda.empty_cache()
    return run


def train_gpt2xl(fa, bsa, ad, report, profile_step=False):
    """Phase 20 (train-gpt2xl, bench.py row_gpt2xl on one card): GPT-2 XL
    (1,557,686,400 parameters) with seeded bf16 weights made by the port,
    through `initialize(model=, model_parameters=)`, on the row's lean
    bs 8 ladder ("dots", "attn_residuals", "full"), its floor (lean bs 4,
    whole-block remat) and one classic-state bs 8 "full" rung. The row's
    last rung, z3_hostopt_bs2, needs ZeRO-3 and the host-offload tier,
    which the port does not carry (ROADMAP A.6/A.7)."""
    from deeperspeed_tpu_torch import GPT2Config
    tree = gpt2_tree(GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16), 3)
    runs = {}
    for tag, bs, policy, lean in GPT2_RUNGS:
        runs[tag] = train_gpt2xl_rung(
            fa, bsa, ad, tree, tag, bs, policy, lean,
            profile_step=profile_step and policy == "full")
    del tree
    torch.cuda.empty_cache()
    out = {"runs": runs, "not_run": {
        "z3_hostopt_bs2": "ZeRO-3 with the host-offload optimizer is not "
                          "ported (ROADMAP A.6/A.7)"},
        "launches": {k: sum(r["launches"][k] for r in runs.values())
                     for k in GPT2_KERNELS}}
    report["train_gpt2xl"] = out
    return out


def legacy_gpt2xl(fa, bsa, ad, report):
    """Phase 21 (train-gpt2xl-legacy): GPT-2 XL, lean, "full" remat,
    micro 4 x gas 2. Three steps through forward / backward / step from
    the same weights as three through train_batch: the losses equal bit
    for bit. Then set_layers_to_hook(["transformerlayer"]) on one batch
    (48 captures of [4, 1024, 1600] from one capture forward) and
    enable_gradient_noise_scale (a finite estimate after n_batches)."""
    from deeperspeed_tpu_torch import GPT2Config
    tree = gpt2_tree(GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16), 3)
    conf = gpt2_conf(8, True, micro=4, gas=2)
    tokens = gpt2_tokens(8, gas=2)
    L = GPT2_XL["num_layers"]
    losses, by_pass = {}, {}
    for path in ("train_batch", "legacy"):
        eng, model = gpt2_engine(tree, conf, "full")
        reset_attention_counts(fa, bsa)
        ad.reset_launches()
        t0 = time.perf_counter()
        out = []
        for _ in range(3):
            if path == "train_batch":
                out.append(eng.train_batch(batch=(tokens, tokens)))
                continue
            for i in range(2):
                loss = eng(((tokens[i], tokens[i])))
                eng.backward(loss)
                got = eng.step()
                if (got is None) != (i == 0):
                    fail(f"phase 21: step() at micro-batch {i} returned "
                         f"{got}")
            out.append(got)
        torch.cuda.synchronize()
        losses[path] = out
        launches, design, variants = gpt2_launch_check(
            fa, bsa, ad, f"phase 21 ({path})",
            gpt2_step_launches(L, 3, 2, micro_steps=2), True)
        by_pass[path] = {k: launches[k] for k in GPT2_KERNELS}
        print(f"  {path}: losses {out}, {time.perf_counter() - t0:.2f} s, "
              f"launches {launches['flash_fwd']} / "
              f"{launches['flash_bwd_dkv']} / {launches['flash_bwd_dq']} "
              f"flash, {variants} Adam", flush=True)
        if path == "legacy":
            break
        del eng, model
        torch.cuda.empty_cache()
    if losses["legacy"] != losses["train_batch"]:
        fail(f"phase 21: the legacy loop's losses {losses['legacy']} != "
             f"train_batch's {losses['train_batch']}")
    # layer hooks on one batch: one capture forward, the 48 blocks
    reset_attention_counts(fa, bsa)
    ad.reset_launches()
    calls = []
    real = model.hidden_states

    def counted(*a, **kw):
        outs = real(*a, **kw)
        calls.append(len(outs))
        return outs
    model.hidden_states = counted
    eng.set_layers_to_hook(["transformerlayer"])
    eng(((tokens[0], tokens[0])))
    eng._cached_loss = None
    hooked = eng.get_hooked_activations()
    model.hidden_states = real
    shapes = {tuple(t.shape) for t in hooked.values()}
    if len(hooked) != L or calls != [L + 2] or \
            shapes != {(4, GPT2_SEQ, GPT2_XL["hidden_size"])} or \
            sorted(hooked) != list(range(1, L + 1)) or \
            not all(bool(torch.isfinite(t).all()) for t in hooked.values()):
        fail(f"phase 21: {len(hooked)} captures of {shapes} from capture "
             f"forwards {calls}, want {L} of (4, {GPT2_SEQ}, "
             f"{GPT2_XL['hidden_size']}) from one forward of {L + 2} "
             f"outputs")
    eng(((tokens[0], tokens[0])))   # disarmed: captures nothing new
    eng._cached_loss = None
    if calls != [L + 2]:
        fail(f"phase 21: the capture did not disarm: {calls}")
    del hooked
    # the gradient-noise-scale estimator over two micro-batches
    gns = eng.enable_gradient_noise_scale(n_batches=2)
    for i in range(2):
        eng.backward(eng(((tokens[i], tokens[i]))))
    eng.step()
    est = {"scale": gns.scale, "noise": gns.noise,
           "noise_scale": gns.noise_scale, "n_updates": gns.n_updates}
    print(f"  hooks: {L} captures of {sorted(shapes)} from one capture "
          f"forward; gradient noise scale {est}", flush=True)
    if gns.n_updates != 2 or not all(
            x is not None and np.isfinite(x) for x in
            (gns.scale, gns.noise, gns.noise_scale)):
        fail(f"phase 21: no finite gradient-noise-scale estimate: {est}")
    # the capture call: L in the capture forward (no remat) and L in the
    # loss forward; the disarmed call L; the two micro-steps 2L each
    # (the "full" recompute) and their backward, one Adam
    launches, _, _ = gpt2_launch_check(
        fa, bsa, ad, "phase 21 (hooks and noise scale)",
        dict(flash_fwd=7 * L, flash_bwd_dkv=2 * L, flash_bwd_dq=2 * L,
             adam=1), True)
    by_pass["hooks_and_noise_scale"] = {k: launches[k] for k in GPT2_KERNELS}
    del eng, model, tree, gns
    torch.cuda.empty_cache()
    out = {"losses": losses, "identical": True, "hooked_layers": L,
           "hook_shape": [4, GPT2_SEQ, GPT2_XL["hidden_size"]],
           "capture_forwards": len(calls), "gradient_noise_scale": est,
           "launches_by_pass": by_pass,
           "launches": {k: sum(n[k] for n in by_pass.values())
                        for k in GPT2_KERNELS}}
    report["train_gpt2xl_legacy"] = out
    return out


def serve_gpt2xl(fa, da, report):
    """Phase 22 (serve-gpt2xl): GPT-2 XL with seeded bf16 weights behind
    phase 4's "inference" block, row_serve's stream."""
    from deeperspeed_tpu_torch import GPT2, GPT2Config
    model = GPT2(GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16),
                 device="cuda").init_params(6)
    return serve(fa, da, report, model=model, key="serve_gpt2xl")


def gpt2_parity(fa, bsa, report):
    """Phase 23: GPT-2 XL's widths at 4 layers in fp32, kernels vs the
    plain path: 3 steps of micro 2 x gas 2 x 1024 each way (losses within
    rtol 1e-4), and the same weights served (the same greedy tokens)."""
    from deeperspeed_tpu_torch import GPT2, GPT2Config, InferenceEngine
    cfg = dataclasses.replace(GPT2Config.megatron_1_5b(), num_layers=4)
    tree = gpt2_tree(cfg, 7)
    conf = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "steps_per_print": 10_000,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    tokens = gpt2_tokens(4, gas=2, seed=8)
    losses = {}
    for use_kernels in (True, False):
        reset_attention_counts(fa, bsa)
        eng, model = gpt2_engine(tree, conf, "full", cfg=cfg,
                                 use_kernels=use_kernels)
        losses[use_kernels] = [eng.train_batch(batch=(tokens, tokens))
                               for _ in range(3)]
        got = attention_counts(fa, bsa)["flash_fwd"]
        if got != (2 * 4 * 2 * 3 if use_kernels else 0):
            fail(f"phase 23: {got} flash forward launches with use_kernels "
                 f"{use_kernels}")
        del eng, model
        torch.cuda.empty_cache()
    fast, plain = np.array(losses[True]), np.array(losses[False])
    rel = np.abs(fast - plain) / np.abs(plain)
    print(f"  training: losses kernels {losses[True]} vs plain "
          f"{losses[False]}: max relative difference {rel.max():.3e}",
          flush=True)
    if not (np.isfinite(fast).all() and (rel <= 1e-4).all()):
        fail(f"phase 23: fp32 GPT-2 losses differ between the kernel path "
             f"and the plain path beyond rtol 1e-4: {losses}")
    model = GPT2(cfg, device="cuda")
    model.load_jax_params(tree)
    rng = np.random.default_rng(9)
    lens = [9, 64, 65, 130, 300, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    fast = InferenceEngine(model, config=SERVE_CONFIG).generate(
        prompts, max_new_tokens=16)
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(SERVE_CONFIG))
    plain_cfg["inference"]["kernel"] = "xla"
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    same = [a == b for a, b in zip(fast, plain)]
    print(f"  serving: {sum(same)}/{len(same)} requests token-identical",
          flush=True)
    if not all(same):
        fail(f"phase 23: greedy GPT-2 tokens differ between the kernel "
             f"path and the plain path: {fast} vs {plain}")
    del model, tree
    torch.cuda.empty_cache()
    report["gpt2_parity"] = {"losses_kernels": losses[True],
                             "losses_plain": losses[False],
                             "max_rel_diff": float(rel.max()), "rtol": 1e-4,
                             "prompt_lengths": lens, "identical": same}
    return report["gpt2_parity"]


def print_gpt2(tg, lg, sg, card):
    for tag, r in tg["runs"].items():
        print(f"  {tag}: {r['tokens_per_s']:.0f} tokens/s, MFU "
              f"{r['gpt2_xl_1p5b_mfu']:.4f}, step {r['step_ms_median']:.1f} "
              f"ms, peak {r['peak_gb']:.2f} GiB, loss {r['losses'][0]:.4f} "
              f"-> {r['losses'][-1]:.4f} on {card}", flush=True)
        if "profile" in r:
            print_profile(f"{tag} step (profiled)", r["profile"], card)
            pr = r["profile"]
            print(f"  shares of device time: flash "
                  f"{pr['device_share_flash']:.3f} "
                  f"({pr['device_ms_per_step_flash']:.3f} ms), cuBLAS "
                  f"GEMMs (nvjet) {pr['device_share_nvjet']:.3f} "
                  f"({pr['device_ms_per_step_nvjet']:.3f} ms), Adam "
                  f"{pr['device_ms_per_step_adam_kernel']:.3f} ms",
                  flush=True)
    print(f"  legacy loop: losses {lg['losses']['legacy']} (identical to "
          f"train_batch)", flush=True)
    print(f"  serve-gpt2xl: {sg['generated_tokens']} tokens in "
          f"{sg['wall_s']:.3f} s: {sg['tokens_per_s']:.1f} tokens/s, TTFT "
          f"p50 {sg['ttft_p50_ms']:.2f} ms, inter-token p50 "
          f"{sg['inter_token_p50_ms']:.2f} ms / p99 "
          f"{sg['inter_token_p99_ms']:.2f} ms, launches {sg['launches']} on "
          f"{card}", flush=True)


def gpt2_only(card, profile_step=False):
    """Phase 3's GPT-2 XL checks (the Adam variants at its size, the
    attention kernels at its shapes) and phases 20-23 alone."""
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s", flush=True)
    report = {"card": card}
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_adam_xl(ad, gen, report)
    check_gpt2_attention(fa, da, gen, report)
    run_gpt2_phases(fa, bsa, da, ad, report, card, profile_step)
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_gpt2.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    return 0


def run_gpt2_phases(fa, bsa, da, ad, report, card, profile_step=False):
    print("GPT-2 XL training train-gpt2xl (bf16, lean / classic state, "
          "ZeRO-0):", flush=True)
    tg = train_gpt2xl(fa, bsa, ad, report, profile_step)
    print("GPT-2 XL legacy loop train-gpt2xl-legacy (lean, full remat, "
          "micro 4 x gas 2):", flush=True)
    lg = legacy_gpt2xl(fa, bsa, ad, report)
    print("serving GPT-2 XL serve-gpt2xl (bf16):", flush=True)
    sg = serve_gpt2xl(fa, da, report)
    print("GPT-2 parity (XL widths, 4 layers, fp32, kernels vs plain):",
          flush=True)
    gp = gpt2_parity(fa, bsa, report)
    print_gpt2(tg, lg, sg, card)
    return tg, lg, sg, gp



# ---------------------------------------------------------------------------
# phases 24-26: the prefix cache and speculative decoding
# ---------------------------------------------------------------------------

def prefix_prompts(rng, shared, vocab, n_req=PREFIX_REQUESTS):
    """row_serve_prefix's make_prompts: every fifth prompt has a cold
    random prefix as long as the shared one, the others share it; tails of
    8-48 tokens."""
    out = []
    for i in range(n_req):
        tail = list(rng.integers(1, vocab, size=int(rng.integers(8, 48))))
        if i % 5 == 4:
            out.append(list(rng.integers(1, vocab, size=PREFIX_LEN)) + tail)
        else:
            out.append(shared + tail)
    return out


def program_calls(eng, duty):
    """Calls so far of one duty's bucket programs: "prefill" (the full
    prefill), "decode", "chunk" or "spec_propose"."""
    return sum(n for key, n in eng.program_calls.items() if key[0] == duty)


def prefix_stream(eng, prompts):
    """row_serve_prefix's stream(): submit every prompt, drain, and give
    each token a running request appended the gap since its previous step
    (a speculative step's gap spread over the tokens it appended) → the
    engine-stats delta, the inter-token p50 (s), the finished requests in
    submission order and the full-prefill / decode calls it made."""
    before = dict(eng.stats)
    full, decode = program_calls(eng, "prefill"), program_calls(eng, "decode")
    last, itl = {}, []
    ids = [eng.submit(p, max_new_tokens=PREFIX_NEW) for p in prompts]
    while eng.scheduler.has_work:
        eng.step()
        now = time.perf_counter()
        for r in list(eng.scheduler.running):
            k = len(r.generated)
            if k and r.request_id in last and k > last[r.request_id][1]:
                n = k - last[r.request_id][1]
                itl.extend([(now - last[r.request_id][0]) / n] * n)
            if k:
                last[r.request_id] = (now, k)
    done = {r.request_id: r for r in eng.scheduler.pop_finished()}
    return {"delta": {k: v - before[k] for k, v in eng.stats.items()
                      if isinstance(v, (int, float))},
            "p50_s": float(np.percentile(np.asarray(itl), 50)),
            "done": [done[i] for i in ids],
            "full_prefill_calls": program_calls(eng, "prefill") - full,
            "decode_steps": program_calls(eng, "decode") - decode}


def check_prefix_requests(what, run, vocab):
    if any(r.status != "ok" or len(r.generated) != PREFIX_NEW or
           not all(0 <= t < vocab for t in r.generated)
           for r in run["done"]):
        fail(f"{what}: not every request finished ok with {PREFIX_NEW} "
             f"tokens: {[(r.request_id, r.status) for r in run['done']]}")


def check_registry(what, eng):
    """No page leaked, and each registered page held by the registry
    alone → the registered page count."""
    pc = eng.prefix_cache
    reg = pc.stats["registered_pages"] if pc is not None else 0
    if eng.cache.num_free != eng.cache.num_pages - 1 - reg:
        fail(f"{what}: pages leaked: {eng.cache.num_free} free of "
             f"{eng.cache.num_pages - 1} with {reg} registered")
    if sorted(eng.cache._refcount.values()) != [1] * reg:
        fail(f"{what}: registered pages not held by the registry alone: "
             f"{sorted(eng.cache._refcount.values())}")
    return reg


def reset_serving_counts(fa, da, qm=None):
    torch.cuda.synchronize()
    fa.launches = 0
    fa.reset_design_launches()
    da.launches = da.launches_int8 = 0
    da.reset_launches_by_design()
    if qm is not None:
        qm.launches = 0
        qm.reset_design_launches()


def serve_prefix(fa, da, report, target, draft, key):
    """Phase 24 (GPT-NeoX-125M and the row's 4-layer draft) and phase 25
    (GPT-2 XL and GPT-2 small): bench.py's row_serve_prefix on the card.
    A cache-off, non-speculative engine serves two streams (the second
    measured), then an engine with the prefix cache and k = 4 speculation
    serves three (the third measured). Exact launches: the flash forward
    L a full prefill call (prefix hits take the chunk program), paged
    decode L a decode step in the cache-off engine, and in the other the
    draft's (k + 1) x its layers a speculative step: on the cluster kernel
    where `paged_decode_supported` takes the draft's head dim, else the
    plain version (counted as "plain")."""
    from deeperspeed_tpu_torch import InferenceEngine
    cfg, dcfg = target.config, draft.config
    V, L, DL, k = cfg.vocab_size, cfg.num_layers, dcfg.num_layers, \
        PREFIX_SPEC_K
    draft_kernel = da.paged_decode_supported(dcfg.head_dim,
                                             PREFIX_BLOCK["page_size"])
    rng = np.random.default_rng(0)
    shared = list(rng.integers(1, V, size=PREFIX_LEN))

    base = InferenceEngine(target, config={"inference": PREFIX_BLOCK})
    prefix_stream(base, prefix_prompts(rng, shared, V))        # warm-up
    reset_serving_counts(fa, da)
    b = prefix_stream(base, prefix_prompts(rng, shared, V))
    base_launches = {"flash_fwd": fa.launches, "paged_decode": da.launches}
    check_prefix_requests(f"{key} (cache off)", b, V)
    check_registry(f"{key} (cache off)", base)
    if base_launches != {"flash_fwd": L * b["full_prefill_calls"],
                         "paged_decode": L * b["decode_steps"]} or \
            not b["decode_steps"]:
        fail(f"{key} (cache off): launches {base_launches} != {L} x "
             f"({b['full_prefill_calls']} prefill calls, "
             f"{b['decode_steps']} decode steps)")
    base_design = check_design(fa, f"{key} (cache off)",
                               {"fwd": base_launches["flash_fwd"]})
    base_decode = check_decode_design(da, f"{key} (cache off)",
                                      base_launches, False)

    block = dict(PREFIX_BLOCK, prefix_cache={"enabled": True},
                 speculative={"enabled": True, "num_draft_tokens": k})
    eng = InferenceEngine(target, config={"inference": block},
                          draft_model=draft)
    prefix_stream(eng, prefix_prompts(rng, shared, V))   # warm-up: misses
    prefix_stream(eng, prefix_prompts(rng, shared, V))   # warm-up: hits
    warm = eng.compile_count()
    pcs_before = dict(eng.prefix_cache.stats)
    prompts = prefix_prompts(rng, shared, V)
    reset_serving_counts(fa, da)
    m = prefix_stream(eng, prompts)
    launches = {"flash_fwd": fa.launches, "paged_decode": da.launches,
                "paged_decode_int8": da.launches_int8}
    decode_design = dict(da.launches_by_design)
    design = check_design(fa, key, {"fwd": launches["flash_fwd"]})
    compile_delta = eng.compile_count() - warm
    pcs = {n: v - pcs_before[n] for n, v in eng.prefix_cache.stats.items()}
    d = m["delta"]
    check_prefix_requests(key, m, V)
    reg = check_registry(key, eng)
    want_draft = (k + 1) * DL * d["spec_steps"]
    want_design = {"cluster": want_draft if draft_kernel else 0,
                   "single": 0, "plain": 0 if draft_kernel else want_draft}
    if launches["flash_fwd"] != L * m["full_prefill_calls"] or \
            not m["full_prefill_calls"] or not d["spec_steps"]:
        fail(f"{key}: {launches['flash_fwd']} flash forward launches != "
             f"{L} x {m['full_prefill_calls']} full prefill calls")
    if launches["paged_decode"] != want_design["cluster"] or \
            launches["paged_decode_int8"] or decode_design != want_design:
        fail(f"{key}: paged decode launches {launches}, by design "
             f"{decode_design}, want {want_design} ((k + 1) x {DL} a "
             f"speculative step, {d['spec_steps']} steps)")
    if compile_delta:
        fail(f"{key}: {compile_delta} new bucket programs in the measured "
             f"stream")
    # bf16: the verify's plain chunk attention and a decode on the
    # kernel round differently, so greedy agreement is reported here
    # (phase 26 gates token identity in fp32)
    agree = base.generate(prompts, max_new_tokens=PREFIX_NEW)
    same = [a == r.generated for a, r in zip(agree, m["done"])]
    tokens_same = sum(x == y for a, r in zip(agree, m["done"])
                      for x, y in zip(a, r.generated))
    result = {
        "requests": PREFIX_REQUESTS, "shared_len": PREFIX_LEN,
        "max_new_tokens": PREFIX_NEW, "spec_k": k,
        "hit_rate": pcs["hits"] / max(pcs["lookups"], 1),
        "lookups": pcs["lookups"], "hits": pcs["hits"],
        "saved_tokens": pcs["saved_prefill_tokens"],
        "registered_pages": reg,
        "base_prefill_tok_s": b["delta"]["prefill_tokens"] /
        b["delta"]["prefill_s"],
        "prefill_tok_s": d["prefill_tokens"] / d["prefill_s"],
        "spec_acceptance": d["spec_accepted"] / max(d["spec_proposed"], 1),
        "spec_steps": d["spec_steps"], "spec_proposed": d["spec_proposed"],
        "spec_accepted": d["spec_accepted"],
        "base_p50_token_ms": b["p50_s"] * 1e3,
        "p50_token_ms": m["p50_s"] * 1e3,
        "p50_speedup": b["p50_s"] / m["p50_s"],
        "compile_delta": compile_delta,
        "base_prefill_s": b["delta"]["prefill_s"],
        "base_decode_s": b["delta"]["decode_s"],
        "prefill_s": d["prefill_s"], "decode_s": d["decode_s"],
        "spec_step_ms": d["decode_s"] / d["spec_steps"] * 1e3,
        "base_decode_step_ms": b["delta"]["decode_s"] / b["decode_steps"] *
        1e3,
        "full_prefill_calls": m["full_prefill_calls"],
        "chunk_calls": {"/".join(map(str, key_)): n for key_, n in
                        eng.program_calls.items() if key_[0] == "chunk"},
        "base_full_prefill_calls": b["full_prefill_calls"],
        "base_decode_steps": b["decode_steps"],
        "launches": launches, "design_launches": design,
        "decode_design_launches": decode_design,
        "base_launches": base_launches, "base_design_launches": base_design,
        "base_decode_design_launches": base_decode["paged_decode"],
        "bf16_agreement": {"requests_identical": sum(same),
                           "tokens_equal": tokens_same,
                           "tokens": sum(len(r.generated)
                                         for r in m["done"])},
        "dtypes": eng.dtypes,
    }
    report[key] = result
    del eng, base
    torch.cuda.empty_cache()
    return result


def print_prefix(r, card, key):
    print(f"  {key}: hit rate {r['hit_rate']:.4f} ({r['hits']}/"
          f"{r['lookups']}), saved {r['saved_tokens']} prefill tokens, "
          f"effective prefill {r['prefill_tok_s']:.1f} tokens/s (cache off "
          f"{r['base_prefill_tok_s']:.1f}), acceptance "
          f"{r['spec_acceptance']:.4f} ({r['spec_accepted']}/"
          f"{r['spec_proposed']}), inter-token p50 {r['p50_token_ms']:.2f} "
          f"ms (cache off {r['base_p50_token_ms']:.2f}, speed-up "
          f"{r['p50_speedup']:.3f}), a speculative step "
          f"{r['spec_step_ms']:.2f} ms (a decode step "
          f"{r['base_decode_step_ms']:.2f}), compile_delta "
          f"{r['compile_delta']}, launches {r['launches']} "
          f"{r['decode_design_launches']} (cache off {r['base_launches']}), "
          f"bf16 agreement {r['bf16_agreement']} on {card}", flush=True)


def prefix_parity_case(fa, da, qm, what, target, draft, extra,
                       draft_quant=None):
    """One pair of phase 26: a shared-prefix stream served twice (misses,
    then hits) by the prefix + speculative engine through the kernels and
    through the plain path (``inference.kernel: "xla"``, ``use_kernels``
    off), and by a cache-off, non-speculative engine through the kernels;
    fp32, so greedy tokens must be identical. The plain path must launch
    no kernel."""
    from deeperspeed_tpu_torch import InferenceEngine
    V = target.config.vocab_size
    rng = np.random.default_rng(5)
    shared = list(rng.integers(1, V, size=PREFIX_LEN))
    prompts = prefix_prompts(rng, shared, V, n_req=10)
    spec = {"enabled": True, "num_draft_tokens": PREFIX_SPEC_K}
    if draft_quant:
        spec["draft_weight_quant"] = draft_quant
    both = dict(PREFIX_BLOCK, **extra, prefix_cache={"enabled": True},
                speculative=spec)
    runs, counts = {}, {}
    for path in ("kernels", "plain"):
        target.use_kernels = path == "kernels"
        block = dict(both, kernel="auto" if path == "kernels" else "xla")
        reset_serving_counts(fa, da, qm)
        eng = InferenceEngine(target, config={"inference": block},
                              draft_model=draft)
        runs[path] = [eng.generate(prompts, 16) for _ in range(2)]
        torch.cuda.synchronize()
        counts[path] = {"flash_fwd": fa.launches,
                        "paged_decode": da.launches,
                        "paged_decode_int8": da.launches_int8,
                        "paged_decode_plain": da.launches_by_design["plain"]
                        + da.launches_by_design_int8["plain"],
                        "quant_matmul": qm.launches}
        check_registry(f"{what} ({path})", eng)
        counts[path]["hits"] = eng.prefix_cache.stats["hits"]
        counts[path]["spec_steps"] = eng.stats["spec_steps"]
        del eng
    target.use_kernels = True
    base = InferenceEngine(target, config={"inference": dict(
        PREFIX_BLOCK, **extra)})
    runs["cache_off"] = [base.generate(prompts, 16) for _ in range(2)]
    del base
    torch.cuda.empty_cache()
    same = [[a == b == c for a, b, c in zip(*(runs[p][i] for p in runs))]
            for i in range(2)]
    print(f"  {what}: {sum(map(sum, same))}/{2 * len(prompts)} requests "
          f"token-identical (kernels, plain, cache off); launches {counts}",
          flush=True)
    if not all(map(all, same)):
        fail(f"{what}: greedy tokens differ between the kernel path, the "
             f"plain path and the cache-off engine: {runs}")
    if any(v for n, v in counts["plain"].items()
           if n not in ("hits", "spec_steps")) or \
            not counts["kernels"]["flash_fwd"] or \
            not counts["kernels"]["hits"]:
        fail(f"{what}: launches {counts}: the plain path must launch no "
             f"kernel, the kernel path the flash forward on its misses")
    return {"identical": same, "launches": counts,
            "prompts": len(prompts), "extra": extra,
            "draft_weight_quant": draft_quant}


def prefix_lifecycle(target, draft, new_target):
    """Phase 26(c) on (a)'s pair: `hot_swap_weights` on a warm prefix +
    speculative engine drops the registry with no new bucket program and
    then serves what a fresh engine on the new weights serves; a
    temperature-0.8 speculative stream drawn by one engine is drawn again,
    token for token, by a second one after `restore_sampler_state`."""
    from deeperspeed_tpu_torch import InferenceEngine
    V = target.config.vocab_size
    rng = np.random.default_rng(6)
    shared = list(rng.integers(1, V, size=PREFIX_LEN))
    prompts = prefix_prompts(rng, shared, V, n_req=10)
    spec = {"enabled": True, "num_draft_tokens": PREFIX_SPEC_K}
    block = dict(PREFIX_BLOCK, prefix_cache={"enabled": True},
                 speculative=spec)
    eng = InferenceEngine(target, config={"inference": block},
                          draft_model=draft)
    for _ in range(2):
        eng.generate(prompts, 8)
    registered = eng.prefix_cache.stats["registered_pages"]
    new = dict(new_target.named_parameters())
    swap = eng.hot_swap_weights(new)
    after = eng.prefix_cache.stats["registered_pages"]
    if not registered or after or swap["compile_delta"]:
        fail(f"phase 26(c): hot swap left {after} of {registered} "
             f"registered pages, compile_delta {swap['compile_delta']}")
    got = eng.generate(prompts, 8)
    check_registry("phase 26(c)", eng)
    want = InferenceEngine(target, config={"inference": PREFIX_BLOCK},
                           params=new).generate(prompts, 8)
    swapped_same = [a == b for a, b in zip(got, want)]
    if not all(swapped_same):
        fail(f"phase 26(c): after the swap {got} != a fresh engine's {want}")
    del eng
    sampled = {"inference": dict(PREFIX_BLOCK, temperature=0.8,
                                 speculative=spec)}
    first = InferenceEngine(target, config=sampled, draft_model=draft)
    first.generate(prompts[:5], 8)
    snap = first.sampler_state()
    drawn = first.generate(prompts[5:], 8)
    second = InferenceEngine(target, config=sampled, draft_model=draft)
    second.restore_sampler_state(snap)
    again = second.generate(prompts[5:], 8)
    if again != drawn:
        fail(f"phase 26(c): the restored sampler drew {again}, the first "
             f"engine {drawn}")
    del first, second
    torch.cuda.empty_cache()
    print(f"  phase 26(c): hot swap {swap['swap_ms']:.1f} ms dropped "
          f"{registered} registered pages, compile_delta "
          f"{swap['compile_delta']}, then {sum(swapped_same)}/"
          f"{len(prompts)} requests as a fresh engine's; restored sampler "
          f"{len(drawn)}/{len(drawn)} temperature-0.8 requests identical "
          f"(steps {snap['steps']})", flush=True)
    return {"swap_ms": swap["swap_ms"], "compile_delta":
            swap["compile_delta"], "registered_before": registered,
            "registered_after": after, "after_swap_identical": swapped_same,
            "sampler_steps": snap["steps"], "restored_identical": True}


def prefix_parity(fa, da, qm, report):
    """Phase 26: fp32, kernels vs plain: (a) phase 24's pair at 125M
    widths, the target at 4 layers; (b) phase 25's pair at GPT-2 XL's and
    GPT-2 small's widths, 4 and 2 layers, int8 KV pages and int8 draft
    weights; (c) the weight swap and the sampler snapshot on (a)'s pair."""
    from deeperspeed_tpu_torch import (GPT2, GPT2Config, GPTNeoX,
                                       GPTNeoXConfig)
    neox_cfg = GPTNeoXConfig(**dict(NEOX_125M, num_layers=4))
    target = GPTNeoX(neox_cfg, device="cuda").init_params(11)
    draft = GPTNeoX(GPTNeoXConfig(**PREFIX_DRAFT),
                    device="cuda").init_params(12)
    out = {"a": prefix_parity_case(fa, da, qm, "phase 26(a)", target, draft,
                                   {})}
    new_target = GPTNeoX(neox_cfg, device="cuda").init_params(21)
    out["c"] = prefix_lifecycle(target, draft, new_target)
    del target, draft, new_target
    xl = GPT2(dataclasses.replace(GPT2Config.megatron_1_5b(), num_layers=4),
              device="cuda").init_params(13)
    small = GPT2(dataclasses.replace(GPT2Config.small(), num_layers=2),
                 device="cuda").init_params(14)
    out["b"] = prefix_parity_case(fa, da, qm, "phase 26(b)", xl, small,
                                  {"kv_cache_dtype": "int8"}, "int8")
    k = out["b"]["launches"]["kernels"]
    if not k["paged_decode_int8"] or not k["quant_matmul"]:
        fail(f"phase 26(b): the kernel path launched {k}: the int8 decode "
             f"and the int8 matmul must run")
    del xl, small
    torch.cuda.empty_cache()
    report["prefix_parity"] = out
    return out


def run_prefix_phases(fa, da, qm, report, card):
    from deeperspeed_tpu_torch import GPT2, GPT2Config, GPTNeoX, \
        GPTNeoXConfig
    print("serving with the prefix cache and speculation serve-prefix-125M "
          "(bf16, row_serve_prefix):", flush=True)
    target = build_model(torch.bfloat16)
    draft = GPTNeoX(GPTNeoXConfig(param_dtype=torch.bfloat16,
                                  **PREFIX_DRAFT), device="cuda") \
        .init_params(3)
    sp = serve_prefix(fa, da, report, target, draft, "serve_prefix")
    print_prefix(sp, card, "serve-prefix-125M")
    del target, draft
    print("serving GPT-2 XL with a GPT-2 small draft serve-gpt2xl-spec "
          "(bf16):", flush=True)
    target = GPT2(GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16),
                  device="cuda").init_params(6)
    draft = GPT2(GPT2Config.small(param_dtype=torch.bfloat16),
                 device="cuda").init_params(8)
    sx = serve_prefix(fa, da, report, target, draft, "serve_gpt2xl_spec")
    print_prefix(sx, card, "serve-gpt2xl-spec")
    del target, draft
    torch.cuda.empty_cache()
    print("prefix + speculative parity (fp32, kernels vs plain vs cache "
          "off):", flush=True)
    pp = prefix_parity(fa, da, qm, report)
    return sp, sx, pp


def serve_prefix_only(card):
    """Phases 24-26 alone."""
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s", flush=True)
    report = {"card": card}
    run_prefix_phases(fa, da, qm, report, card)
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_prefix.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases 27-28: serving under failure
# ---------------------------------------------------------------------------

def watch_faults(eng):
    """Record, by fault serial, whether each step's plan had prefill and
    decode work, and every exception the quarantine catches → (plans,
    caught). The engine's own quarantine still runs."""
    plans, caught = {}, []
    schedule = eng.scheduler.schedule
    quarantine = eng._quarantine_batch

    def watched_schedule(now=None):
        plan = schedule(now=now)
        if eng.fault_injector is not None:
            plans[eng.fault_injector.serial - 1] = (
                bool(plan.prefills), bool(plan.decodes))
        return plan

    def watched_quarantine(requests, exc, phase):
        caught.append((phase, type(exc).__name__, str(exc)))
        return quarantine(requests, exc, phase)

    eng.scheduler.schedule = watched_schedule
    eng._quarantine_batch = watched_quarantine
    return plans, caught


def injected_with_work(eng, plans, lost=()):
    """The prefill_error / decode_error faults that fired on a step with
    work of their phase: each of them must be one quarantine. A step in
    ``lost`` lost its pools in the prefill, so its decode was skipped."""
    fired = eng.fault_injector.fired if eng.fault_injector else []
    return sum(1 for serial, kind in fired
               if (kind == "prefill_error" and plans[serial][0]) or
               (kind == "decode_error" and plans[serial][1] and
                serial not in lost))


def chaos_prompts(eng, rng, vocab, n_req):
    """row_serve_chaos's prompts: lognormal(5.0, 0.8) lengths clipped to
    8 .. min(768, the top bucket, the window less the new tokens)."""
    hi = min(768, eng.prefill_lengths[-1], eng.max_seq_len - CHAOS_NEW)
    lens = np.clip(np.exp(rng.normal(5.0, 0.8, size=n_req)), 8,
                   hi).astype(int)
    return [list(rng.integers(1, vocab, size=int(n))) for n in lens]


def warm_buckets(eng, rng, vocab):
    """Warm every prefill bucket (b - 2 tokens, so the top bucket's prompt
    plus two tokens still fits the window) and the decode bucket."""
    eng.generate([list(rng.integers(1, vocab, size=b - 2))
                  for b in eng.prefill_lengths], max_new_tokens=2)
    torch.cuda.synchronize()


def program_delta(eng, before, duty):
    return program_calls(eng, duty) - sum(
        n for key, n in before.items() if key[0] == duty)


def chaos_stream(fa, da, model, faults, tag):
    """One variant of phase 27: row_serve_chaos's run() on the card, with
    the launch counts, the clean / storm quarantine checks and a clean
    synchronize."""
    from deeperspeed_tpu_torch import InferenceEngine
    from deeperspeed_tpu_torch.inference import RequestRejected
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_layers
    block = dict(CHAOS_BLOCK)
    if faults:
        block["fault_injection"] = {"faults": faults}
    eng = InferenceEngine(model, config={"inference": block})
    plans, caught = watch_faults(eng)
    rng = np.random.default_rng(0)
    prompts = chaos_prompts(eng, rng, V, CHAOS_REQUESTS)
    warm_buckets(eng, rng, V)
    warm = eng.compile_count()
    calls = dict(eng.program_calls)
    keys = ("requests_ok", "requests_deadline_exceeded", "requests_failed",
            "requests_shed", "quarantines", "retries", "evictions")
    base = {k: eng.stats[k] for k in keys}
    reset_serving_counts(fa, da)

    submit_at, first_tok = {}, {}
    shed = submitted = step = 0
    t_start = time.perf_counter()
    while submitted < len(prompts) or eng.scheduler.has_work:
        while submitted < len(prompts) and submitted * 2 <= step:
            try:
                rid = eng.submit(prompts[submitted],
                                 max_new_tokens=CHAOS_NEW)
                submit_at[rid] = time.perf_counter()
            except RequestRejected:
                shed += 1
            submitted += 1
        if eng.scheduler.has_work:
            try:
                eng.step()
            except BaseException as e:  # noqa: BLE001 - the row's gate
                fail(f"{tag}: the server died: {type(e).__name__}: {e}")
        now = time.perf_counter()
        for r in list(eng.scheduler.running) + eng.scheduler.finished:
            rid = r.request_id
            if rid in submit_at and rid not in first_tok and r.generated:
                first_tok[rid] = now - submit_at[rid]
        step += 1
        if now - t_start > 600:
            fail(f"{tag}: the stream did not end within 600 s")
    torch.cuda.synchronize()       # raises on a sticky CUDA error
    dt = time.perf_counter() - t_start
    launches = {"flash_fwd": fa.launches, "paged_decode": da.launches}
    d = {k: eng.stats[k] - base[k] for k in keys}
    done = [r for r in eng.scheduler.finished if r.request_id in submit_at]
    ids = [r.request_id for r in done]
    all_terminal = sorted(ids) == sorted(submit_at) and sum(
        d[k] for k in ("requests_ok", "requests_deadline_exceeded",
                       "requests_failed")) == len(submit_at)
    leaked = eng.cache.num_pages - 1 - eng.cache.num_free
    compile_delta = eng.compile_count() - warm
    prefill_calls = program_delta(eng, calls, "prefill")
    decode_steps = program_delta(eng, calls, "decode")
    expected = injected_with_work(eng, plans)
    fired = list(eng.fault_injector.fired) if eng.fault_injector else []
    if not all_terminal or leaked or compile_delta:
        fail(f"{tag}: invariants broken: all_terminal {all_terminal}, "
             f"{leaked} pages leaked, compile_delta {compile_delta}")
    if any(r.status == "ok" and (len(r.generated) != CHAOS_NEW or not all(
            0 <= t < V for t in r.generated)) for r in done):
        fail(f"{tag}: a request ended ok with the wrong tokens")
    if faults is None and (d["quarantines"] or d["requests_failed"] or
                           caught):
        fail(f"{tag}: the clean stream quarantined {d['quarantines']} "
             f"batches and failed {d['requests_failed']} requests: "
             f"{caught}")
    if faults is not None and (
            not expected or d["quarantines"] != expected or
            len(caught) != expected or
            any(name != "InjectedServingFault" for _, name, _ in caught)):
        fail(f"{tag}: {d['quarantines']} quarantines, {expected} injected "
             f"errors fired on a step with work (fired {fired}); caught "
             f"{caught}")
    if launches != {"flash_fwd": L * prefill_calls,
                    "paged_decode": L * decode_steps} or \
            not prefill_calls or not decode_steps:
        fail(f"{tag}: launches {launches} != {L} x ({prefill_calls} "
             f"prefill calls, {decode_steps} decode steps)")
    design = check_design(fa, tag, {"fwd": launches["flash_fwd"]})
    decode_design = check_decode_design(da, tag, launches, False)
    ttft = sorted(first_tok.values())

    def pct(q):
        return float(np.percentile(np.asarray(ttft), q) * 1e3)

    gen = sum(len(r.generated) for r in done)
    result = {
        "requests": submitted, "accepted": len(submit_at),
        "success_rate": d["requests_ok"] / max(submitted, 1),
        "shed_fraction": shed / max(submitted, 1),
        "ttft_p50_ms": pct(50), "ttft_p99_ms": pct(99),
        "tokens_per_s": gen / dt, "generated_tokens": gen, "wall_s": dt,
        "quarantines": d["quarantines"], "retries": d["retries"],
        "evictions": d["evictions"], "requests_failed": d["requests_failed"],
        "requests_deadline_exceeded": d["requests_deadline_exceeded"],
        "requests_shed": d["requests_shed"], "server_up": True,
        "all_terminal": all_terminal, "pages_leaked": leaked,
        "compile_delta": compile_delta, "fired": fired,
        "injected_with_work": expected, "caught": caught,
        "prefill_calls": prefill_calls, "decode_steps": decode_steps,
        "launches": launches, "design_launches": design,
        "decode_design_launches": decode_design["paged_decode"],
    }
    del eng
    torch.cuda.empty_cache()
    return result


def chaos_watchdog(model):
    """Phase 27(b): the hang watchdog on the card. A 1.0 s decode stall
    past the warm-up trips a 0.25 s timeout once; `run()` then drains and
    exits 0 with every accepted request terminal. A fresh engine whose
    programs are cold never arms, though its steps outlast its
    timeout."""
    from deeperspeed_tpu_torch import InferenceEngine
    V = model.config.vocab_size
    block = dict(CHAOS_BLOCK, hang_timeout_s=CHAOS_HANG_TIMEOUT_S,
                 fault_injection={"faults": [{
                     "kind": "decode_stall", "step": CHAOS_STALL_STEP,
                     "seconds": CHAOS_STALL_S}]})
    eng = InferenceEngine(model, config={"inference": block})
    plans, _ = watch_faults(eng)
    rng = np.random.default_rng(1)
    prompts = chaos_prompts(eng, rng, V, CHAOS_HANG_REQUESTS)
    warm_buckets(eng, rng, V)
    warm_serial = eng.fault_injector.serial
    if warm_serial >= CHAOS_STALL_STEP or eng.watchdog_fires:
        fail(f"phase 27(b): the warm-up took {warm_serial} steps (the "
             f"stall is at {CHAOS_STALL_STEP}) and fired the watchdog "
             f"{eng.watchdog_fires} times")
    ids = [eng.submit(p, max_new_tokens=CHAOS_NEW) for p in prompts]
    t0 = time.perf_counter()
    code = "returned"
    try:
        eng.run()
    except SystemExit as e:
        code = e.code
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    done = {}
    for r in eng.scheduler.finished:
        if r.request_id in done:
            fail(f"phase 27(b): request {r.request_id} ended twice")
        done[r.request_id] = r.status
    dump = eng.last_stack_dump or ""
    stalled = (CHAOS_STALL_STEP, "decode_stall") in eng.fault_injector.fired
    if code != 0 or eng.watchdog_fires != 1 or not stalled or \
            not plans[CHAOS_STALL_STEP][1]:
        fail(f"phase 27(b): run() ended with {code!r} (want SystemExit(0)), "
             f"the watchdog fired {eng.watchdog_fires} times (want 1), "
             f"stall fired {stalled}")
    if "MainThread" not in dump or "ds-hang-watchdog" not in dump:
        fail(f"phase 27(b): the stack dump does not name the threads: "
             f"{dump[:400]}")
    if sorted(done) != sorted(ids) or \
            any(s != "ok" for s in done.values()):
        fail(f"phase 27(b): accepted {ids}, terminal {done}")
    eng.watchdog.stop()
    del eng

    cold = InferenceEngine(model, config={"inference": dict(
        CHAOS_BLOCK, hang_timeout_s=CHAOS_COLD_TIMEOUT_S)})
    cold.submit(prompts[0], max_new_tokens=2)
    step_s = []
    while cold.scheduler.has_work:
        t = time.perf_counter()
        cold.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    time.sleep(0.1)                # several of the watchdog's polls
    if cold.watchdog_fires or min(step_s) <= CHAOS_COLD_TIMEOUT_S or \
            set(cold.program_calls.values()) != {1}:
        fail(f"phase 27(b): the cold engine fired {cold.watchdog_fires} "
             f"times over steps of {step_s} s (timeout "
             f"{CHAOS_COLD_TIMEOUT_S} s), programs {cold.program_calls}")
    cold.watchdog.stop()
    del cold
    torch.cuda.empty_cache()
    return {"exit_code": code, "watchdog_fires": 1, "run_s": run_s,
            "warm_serial": warm_serial, "stall_step": CHAOS_STALL_STEP,
            "stall_s": CHAOS_STALL_S, "timeout_s": CHAOS_HANG_TIMEOUT_S,
            "terminal": sorted(set(done.values())), "requests": len(ids),
            "dump_lines": dump.count("\n") + 1,
            "cold_step_s": step_s, "cold_timeout_s": CHAOS_COLD_TIMEOUT_S,
            "cold_watchdog_fires": 0}


def serve_chaos(fa, da, report):
    """Phase 27: serve-chaos-125M clean and under the storm, then the
    watchdog (27(b))."""
    model = build_model(torch.bfloat16)
    out = {"clean": chaos_stream(fa, da, model, None, "serve-chaos clean"),
           "storm": chaos_stream(fa, da, model, CHAOS_STORM,
                                 "serve-chaos storm")}
    out["chaos_ttft_p99_degradation_pct"] = (
        (out["storm"]["ttft_p99_ms"] - out["clean"]["ttft_p99_ms"]) /
        out["clean"]["ttft_p99_ms"] * 100.0)
    out["watchdog"] = chaos_watchdog(model)
    report["serve_chaos"] = out
    del model
    torch.cuda.empty_cache()
    return out


def print_chaos(r, card):
    for tag in ("clean", "storm"):
        v = r[tag]
        print(f"  serve-chaos-125M {tag}: success_rate "
              f"{v['success_rate']:.4f}, shed_fraction "
              f"{v['shed_fraction']:.4f}, TTFT p50 {v['ttft_p50_ms']:.2f} "
              f"ms / p99 {v['ttft_p99_ms']:.2f} ms, {v['tokens_per_s']:.1f} "
              f"tokens/s, quarantines {v['quarantines']}, retries "
              f"{v['retries']}, evictions {v['evictions']}, failed "
              f"{v['requests_failed']}, fired {v['fired']}, "
              f"{v['prefill_calls']} prefill calls, {v['decode_steps']} "
              f"decode steps, launches {v['launches']}, pages_leaked "
              f"{v['pages_leaked']}, compile_delta {v['compile_delta']} on "
              f"{card}", flush=True)
    w = r["watchdog"]
    print(f"  serve-chaos-125M: chaos_ttft_p99_degradation_pct "
          f"{r['chaos_ttft_p99_degradation_pct']:.1f}; watchdog: fired "
          f"{w['watchdog_fires']} on a {w['stall_s']} s stall at step "
          f"{w['stall_step']} (timeout {w['timeout_s']} s), run() exited "
          f"{w['exit_code']} after {w['run_s']:.2f} s with "
          f"{w['requests']} requests {w['terminal']}; a cold engine "
          f"(timeout {w['cold_timeout_s']} s, steps "
          f"{[round(s, 4) for s in w['cold_step_s']]} s) fired 0 times on "
          f"{card}", flush=True)


def lose_pools_on_prefill(eng, nth):
    """Make the engine's ``nth`` prefill call release the storage of every
    K/V pool (target and draft, int8 data and scales) and raise, as a call
    that died mid-execution would leave them → the fault serials of the
    steps that lost them."""
    from deeperspeed_tpu_torch.inference import QuantizedPages
    run_prefill = eng._run_prefill
    calls, lost = [0], []

    def dying_prefill(plan):
        calls[0] += 1
        if calls[0] != nth:
            return run_prefill(plan)
        lost.append(eng.fault_injector.serial - 1)
        for cache in (eng.cache, eng.draft_cache):
            if cache is None:
                continue
            for pool in (cache.k, cache.v):
                parts = ((pool.data, pool.scale)
                         if isinstance(pool, QuantizedPages) else (pool,))
                for t in parts:
                    t.untyped_storage().resize_(0)
        raise RuntimeError("simulated mid-execution loss of the KV pools")

    eng._run_prefill = dying_prefill
    return lost


def chaos_parity_case(fa, da, qm, what, target, draft, extra,
                      int8=False, lose_at=None):
    """One pair of phase 28: phase 26's shared-prefix stream, served twice
    (misses, then hits) under CHAOS_PARITY_FAULTS by the prefix +
    speculative engine through the kernels ("kernels") and through the
    plain path ("plain"), and by a cache-off, non-speculative engine
    through the kernels ("cache_off", whose target decodes on the paged
    decode kernel: the speculative target only verifies, and the row's
    draft, at head dim 32, takes the plain decode); then by a clean one
    without faults ("clean"). Every request ends ok with identical greedy
    tokens (fp32), no page leaks, and each faulty engine quarantines
    exactly the injected errors that fired on a step with work of their
    phase. ``int8`` serves int8 block weights (target and draft);
    ``lose_at`` makes that prefill call of each faulty engine lose every
    pool."""
    from deeperspeed_tpu_torch import InferenceEngine
    V = target.config.vocab_size
    rng = np.random.default_rng(7)
    shared = list(rng.integers(1, V, size=PREFIX_LEN))
    prompts = prefix_prompts(rng, shared, V, n_req=10)
    spec = {"enabled": True, "num_draft_tokens": PREFIX_SPEC_K}
    top = {}
    if int8:
        spec["draft_weight_quant"] = "int8"
        top = {"quantization": {"weights": "int8"}}
    plain_block = dict(PREFIX_BLOCK, **extra)
    faulty = dict(plain_block, retry=CHAOS_BLOCK["retry"],
                  fault_injection={"faults": CHAOS_PARITY_FAULTS})
    both = dict(faulty, prefix_cache={"enabled": True}, speculative=spec)
    paths = {"kernels": (both, "auto", True), "plain": (both, "xla", True),
             "cache_off": (faulty, "auto", False),
             "clean": (plain_block, "auto", False)}
    runs, counts, faults = {}, {}, {}
    for path, (block, kernel, speculative) in paths.items():
        target.use_kernels = kernel == "auto"
        reset_serving_counts(fa, da, qm)
        eng = InferenceEngine(
            target, config={"inference": dict(block, kernel=kernel), **top},
            draft_model=draft if speculative else None)
        plans, caught = watch_faults(eng)
        lost = ([] if lose_at is None or path == "clean"
                else lose_pools_on_prefill(eng, lose_at))
        waves = []
        for _ in range(2):
            ids = [eng.submit(p, max_new_tokens=16) for p in prompts]
            done = {}
            while eng.scheduler.has_work:
                eng.step()
                for r in eng.scheduler.pop_finished():
                    done[r.request_id] = r
            waves.append([done[i] for i in ids])
        torch.cuda.synchronize()
        statuses = [r.status for w in waves for r in w]
        runs[path] = [[list(r.generated) for r in w] for w in waves]
        counts[path] = {"flash_fwd": fa.launches,
                        "paged_decode": da.launches,
                        "paged_decode_int8": da.launches_int8,
                        "paged_decode_plain": da.launches_by_design["plain"]
                        + da.launches_by_design_int8["plain"],
                        "quant_matmul": qm.launches}
        check_registry(f"{what} ({path})", eng)
        expected = injected_with_work(eng, plans, lost) + len(lost)
        simulated = [c for c in caught if c[1] != "InjectedServingFault"]
        faults[path] = {"fired": list(eng.fault_injector.fired)
                        if eng.fault_injector else [],
                        "quarantines": eng.stats["quarantines"],
                        "retries": eng.stats["retries"],
                        "evictions": eng.stats["evictions"],
                        "expected": expected, "caught": caught,
                        "pools_lost_at": lost}
        pools_lost = eng.cache.pools_lost() or (
            eng.draft_cache is not None and eng.draft_cache.pools_lost())
        if any(s != "ok" for s in statuses) or \
                eng.stats["quarantines"] != expected or \
                len(caught) != expected or \
                len(simulated) != len(lost) or pools_lost or \
                (path != "clean") != bool(expected) or \
                (lose_at is not None and path != "clean" and
                 len(lost) != 1):
            fail(f"{what} ({path}): statuses {statuses}, faults "
                 f"{faults[path]}, pools lost {pools_lost}")
        del eng
    target.use_kernels = True
    torch.cuda.empty_cache()
    same = [[len({str(runs[p][i][j]) for p in runs}) == 1
             for j in range(len(prompts))] for i in range(2)]
    print(f"  {what}: {sum(map(sum, same))}/{2 * len(prompts)} requests "
          f"token-identical (the prefix + speculative engine through the "
          f"kernels and the plain path and a cache-off engine, all under "
          f"faults, and a clean cache-off one); faults "
          f"{ {p: {k: v for k, v in f.items() if k != 'caught'} for p, f in faults.items()} }; "
          f"launches {counts}", flush=True)
    if not all(map(all, same)):
        fail(f"{what}: greedy tokens differ between the paths: {runs}")
    decode = "paged_decode_int8" if extra.get("kv_cache_dtype") == "int8" \
        else "paged_decode"
    if any(v for n, v in counts["plain"].items()) or \
            not counts["kernels"]["flash_fwd"] or \
            not counts["cache_off"]["flash_fwd"] or \
            not counts["cache_off"][decode] or \
            (int8 and not all(counts[p]["quant_matmul"]
                              for p in ("kernels", "cache_off"))):
        fail(f"{what}: launches {counts}: the plain path must launch no "
             f"kernel, the kernel paths the flash forward, the cache-off "
             f"engine the {decode} kernel, int8 weights the int8 matmul")
    return {"identical": same, "launches": counts, "faults": faults,
            "prompts": len(prompts), "extra": extra, "int8_weights": int8,
            "lose_pools_at": lose_at}


def chaos_parity(fa, da, qm, report):
    """Phase 28: fp32, kernels vs plain under faults: (a) phase 26(a)'s
    pair; (b) the same with int8 weights and int8 KV pages, and a
    mid-stream pool loss."""
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    target = GPTNeoX(GPTNeoXConfig(**dict(NEOX_125M, num_layers=4)),
                     device="cuda").init_params(11)
    draft = GPTNeoX(GPTNeoXConfig(**PREFIX_DRAFT),
                    device="cuda").init_params(12)
    out = {"a": chaos_parity_case(fa, da, qm, "phase 28(a)", target, draft,
                                  {})}
    out["b"] = chaos_parity_case(
        fa, da, qm, "phase 28(b)", target, draft,
        {"kv_cache_dtype": "int8"}, int8=True, lose_at=4)
    del target, draft
    torch.cuda.empty_cache()
    report["chaos_parity"] = out
    return out


def run_chaos_phases(fa, da, qm, report, card):
    print("serving under failure serve-chaos-125M (bf16, row_serve_chaos):",
          flush=True)
    sc = serve_chaos(fa, da, report)
    print_chaos(sc, card)
    print("chaos parity (fp32, kernels vs plain vs clean, under faults):",
          flush=True)
    cp = chaos_parity(fa, da, qm, report)
    return sc, cp


# ---------------------------------------------------------------------------
# phase 29: training under failure, train-sentinel-125M
# ---------------------------------------------------------------------------

class LaunchLedger:
    """Phase 29's launches: each run sets the counts to 0 just before it
    and reads them just after; `check` holds a run to its exact counts
    (every flash launch on the tensor-core design) and adds them to the
    phase's totals."""

    def __init__(self, fa, ad):
        self.fa, self.ad = fa, ad
        self.totals = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                       "flash_bwd_dq": 0, "adam": 0}
        self.design = {"fwd": 0, "dkv": 0, "dq": 0}

    def reset(self):
        fa = self.fa
        fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        fa.reset_design_launches()
        self.ad.reset_launches()

    def check(self, what, steps, adam):
        fa = self.fa
        got = {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
               "flash_bwd_dq": fa.bwd_dq_launches, "adam": self.ad.launches}
        L = NEOX_125M["num_layers"]
        want = {"flash_fwd": L * steps, "flash_bwd_dkv": L * steps,
                "flash_bwd_dq": L * steps, "adam": adam}
        if got != want:
            fail(f"{what}: launches {got} != {want} ({L} layers x {steps} "
                 f"steps, {adam} Adam)")
        check_design(self.fa, what, {"fwd": got["flash_fwd"],
                                     "dkv": got["flash_bwd_dkv"],
                                     "dq": got["flash_bwd_dq"]})
        for k in self.totals:
            self.totals[k] += got[k]
        for k, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd_dkv"),
                        ("dq", "flash_bwd_dq")):
            self.design[k] += got[name]
        return got


def sentinel_engine(bs, th=None, ckpt=None, extra=None):
    """GPT-NeoX-125M (seeded bf16 weights made by the port) behind the
    row's JSON at ``bs``, with a "training_health" block ``th``, a
    "checkpoint" block ``ckpt`` and ``extra`` blocks."""
    import deeperspeed_tpu_torch as dst
    conf = {**SENTINEL_BASE, "train_batch_size": bs, **(extra or {})}
    if th is not None:
        conf["training_health"] = th
    if ckpt is not None:
        conf["checkpoint"] = ckpt
    eng, *_ = dst.initialize(model=build_model(torch.bfloat16),
                             config_params=conf)
    return eng


def sentinel_tokens(bs, n=1, seed=0):
    """``n`` seeded batches [1, bs, 1024] over the whole vocabulary (the
    row's tokens: default_rng(0))."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, NEOX_125M["vocab_size"], size=(n, 1, bs, TRAIN_SEQ))).cuda()


def free_cuda():
    """Collect dropped engines (their wrapped methods hold cycles) and
    return their memory to the device."""
    gc.collect()
    torch.cuda.empty_cache()


def flat_snapshot(eng):
    return [t.clone() for t in (eng._master, eng.opt_state.exp_avg,
                                eng.opt_state.exp_avg_sq, eng._params_flat)]


def schedule_state(eng):
    """The host schedules a step boundary moves."""
    return {"global_steps": eng.global_steps,
            "global_samples": eng.global_samples, "lr": eng.get_lr(),
            "adam_step": eng.opt_state.step,
            "bs_iteration": eng.batch_size_scheduler.last_batch_iteration,
            "batch_size": eng.batch_size_scheduler.current_batch_size,
            "pld_theta": float(eng.progressive_layer_drop.get_theta())}


def sentinel_steps(eng, batch, steps):
    """Host ms a step over ``steps`` `train_batch` calls, between device
    syncs; and the last loss."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = eng.train_batch(batch=batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, loss


def sentinel_rung(ledger, bs, tmp, profile_step=False):
    """29(a): bench.py row_sentinel's rung at ``bs``. The row: a fresh
    engine with the sentinel off, then one with it on, 3 warm-up and 8
    timed steps each. Then the same two engines and a third under policy
    warn (the same probe without the host read of its flag before Adam)
    take turns, 8 steps at a time, for ``SENTINEL_ROUNDS`` rounds in
    alternating order: the medians give the overhead from one card, with
    the read and without. With
    ``profile_step`` each of the three also runs 3 profiled steps. Then
    the recovery: 4 steps, a sync save, and the faulted step timed to its
    return after a device sync."""
    tokens = sentinel_tokens(bs)[0]
    batch = (tokens, tokens)
    engines, row = {}, {}
    for tag, th in (("off", None), ("on", SENTINEL_ON),
                    ("warn", SENTINEL_WARN)):
        eng = engines[tag] = sentinel_engine(bs, th=th)
        ledger.reset()
        for _ in range(SENTINEL_WARMUP):
            eng.train_batch(batch=batch)
        row[tag], _ = sentinel_steps(eng, batch, SENTINEL_STEPS)
        n = SENTINEL_WARMUP + SENTINEL_STEPS
        ledger.check(f"train-sentinel bs {bs} {tag}", n, n)
    blocks = {tag: [] for tag in engines}
    for r in range(SENTINEL_ROUNDS):
        for tag in (list(engines) if r % 2 == 0 else list(engines)[::-1]):
            ledger.reset()
            ms, loss = sentinel_steps(engines[tag], batch, SENTINEL_STEPS)
            ledger.check(f"train-sentinel bs {bs} {tag} round {r}",
                         SENTINEL_STEPS, SENTINEL_STEPS)
            blocks[tag].append(ms)
    n = SENTINEL_WARMUP + SENTINEL_STEPS * (SENTINEL_ROUNDS + 1)
    prof = {}
    for tag, eng in engines.items():
        if not np.isfinite(loss) or eng.global_steps != n:
            fail(f"train-sentinel bs {bs} {tag}: loss {loss}, "
                 f"{eng.global_steps} steps taken of {n}")
        if eng.sentinel is not None and (eng.sentinel.anomalies or
                                         int(eng.health.quarantined)):
            fail(f"train-sentinel bs {bs} {tag}: the sentinel flagged a "
                 f"clean run: {eng.sentinel.quarantined_windows}")
        if profile_step:
            prof[tag] = profile_window(
                lambda: eng.train_batch(batch=batch), 3, share_of="flash")
    del engines, eng
    free_cuda()

    save_dir = os.path.join(tmp, f"rung_bs{bs}")
    eng = sentinel_engine(bs, th=SENTINEL_ROLLBACK,
                          ckpt={"save_dir": save_dir})
    ledger.reset()
    for _ in range(4):
        eng.train_batch(batch=batch)
    eng.save_checkpoint(save_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.train_batch(batch=batch)   # NaN gradients -> rollback
    torch.cuda.synchronize()
    recovery_ms = (time.perf_counter() - t0) * 1e3
    # the faulted step skips its update before the rollback
    ledger.check(f"train-sentinel bs {bs} recovery", 5, 4)
    rollbacks = eng.sentinel.rollbacks
    if rollbacks != 1 or eng.global_steps != 4:
        fail(f"train-sentinel bs {bs}: {rollbacks} rollbacks, "
             f"global_steps {eng.global_steps} after the faulted step")
    del eng
    free_cuda()
    med = {tag: float(np.median(v)) for tag, v in blocks.items()}
    return {
        "sentinel_step_ms_off": row["off"],
        "sentinel_step_ms_on": row["on"],
        "sentinel_overhead_pct": (row["on"] - row["off"]) / row["off"] * 100,
        "sentinel_recovery_ms": recovery_ms,
        "sentinel_rollbacks": rollbacks,
        "step_ms_row": row,
        "step_ms_rounds": blocks,
        "step_ms_median": med,
        "overhead_pct_median": (med["on"] / med["off"] - 1) * 100,
        "overhead_pct_median_warn": (med["warn"] / med["off"] - 1) * 100,
        "tokens_per_s_off": bs * TRAIN_SEQ / med["off"] * 1e3,
        **({"profile": prof} if prof else {}),
    }


def sentinel_quarantine(ledger):
    """29(b): a NaN-gradient step at serial 3 under skip_batch, with
    WarmupLR, the batch-size warmup and PLD on: that step launches the
    forward and backward flash kernels and no Adam, leaves every flat
    buffer bit-equal and no schedule moved; the next step launches Adam
    once."""
    th = {"enabled": True, "policy": "skip_batch", "warmup_steps": 3,
          "fault_injection": {"faults": [{"kind": "nan_grads", "step": 3}]}}
    eng = sentinel_engine(SENTINEL_MICRO, th=th, extra=SENTINEL_SCHEDULES)
    batches = sentinel_tokens(SENTINEL_MICRO, 5, seed=1)
    ledger.reset()
    for i in range(3):
        eng.train_batch(batch=(batches[i], batches[i]))
    ledger.check("train-sentinel quarantine, steps 0-2", 3, 3)
    before, sched = flat_snapshot(eng), schedule_state(eng)
    cur_iter = eng.scale_state.cur_iter
    ledger.reset()
    loss = eng.train_batch(batch=(batches[3], batches[3]))
    torch.cuda.synchronize()
    launches = ledger.check("train-sentinel quarantined step", 1, 0)
    changed = [name for name, a, b in zip(
        ("master", "exp_avg", "exp_avg_sq", "params"), before,
        flat_snapshot(eng)) if not torch.equal(a, b)]
    if changed or schedule_state(eng) != sched:
        fail(f"the quarantined step moved {changed}, schedules "
             f"{schedule_state(eng)} vs {sched}")
    if eng.scale_state.cur_iter != cur_iter + 1:
        fail(f"the loss-scale state did not advance on the quarantined "
             f"step: cur_iter {eng.scale_state.cur_iter}")
    record = eng.sentinel.quarantined_windows[-1]
    if record["kinds"] != ["nonfinite_grad"] or \
            eng.sentinel.quarantined != 1:
        fail(f"quarantine record {eng.sentinel.quarantined_windows}")
    ledger.reset()
    eng.train_batch(batch=(batches[4], batches[4]))
    after = ledger.check("train-sentinel step after the quarantine", 1, 1)
    if eng.global_steps != sched["global_steps"] + 1:
        fail(f"the step after the quarantine left global_steps at "
             f"{eng.global_steps}")
    del eng, before
    free_cuda()
    return {"launches_quarantined_step": launches,
            "launches_next_step": after, "record": record,
            "loss": loss, "schedules": sched,
            "state_bit_equal": True}


def sentinel_trajectory(ledger, tmp):
    """29(c): the faulted run (NaN gradients at serial 5 under rollback
    after a save at step 5, then batches 6-7) against a clean run with a
    fault that never fires on batches 0-4 and 6-7: masters and moments
    bit-identical, schedules and counters equal."""
    batches = sentinel_tokens(SENTINEL_MICRO, 8, seed=2)

    def run(tag, fault_step, skip=None, save_at=None):
        save_dir = os.path.join(tmp, f"trajectory_{tag}")
        th = {"enabled": True, "policy": "rollback", "rollback_after": 1,
              "warmup_steps": 100, "fault_injection": {"faults": [
                  {"kind": "nan_grads", "step": fault_step}]}}
        eng = sentinel_engine(SENTINEL_MICRO, th=th,
                              ckpt={"save_dir": save_dir},
                              extra=SENTINEL_SCHEDULES)
        ledger.reset()
        losses = []
        for i in range(len(batches)):
            if i == skip:
                continue
            if i == save_at:
                eng.save_checkpoint(save_dir)
            losses.append(eng.train_batch(batch=(batches[i], batches[i])))
        steps = len(losses)
        ledger.check(f"train-sentinel trajectory {tag}", steps, 7)
        state = {"flat": flat_snapshot(eng), "sched": schedule_state(eng),
                 "scale": tuple(eng.scale_state),
                 "micro_steps": eng.micro_steps,
                 "rollbacks": eng.sentinel.rollbacks}
        del eng
        free_cuda()
        return state, losses

    faulted, f_losses = run("faulted", 5, save_at=5)
    clean, c_losses = run("clean", 10_000, skip=5)
    off = [name for name, a, b in zip(
        ("master", "exp_avg", "exp_avg_sq", "params"), faulted["flat"],
        clean["flat"]) if not torch.equal(a, b)]
    if faulted["rollbacks"] != 1 or off or any(
            faulted[k] != clean[k] for k in ("sched", "scale",
                                             "micro_steps")):
        fail(f"the rolled-back run differs from the clean run: tensors "
             f"{off}, rollbacks {faulted['rollbacks']}, "
             f"{ {k: (faulted[k], clean[k]) for k in ('sched', 'scale')} }")
    return {"bit_identical": True, "faulted_losses": f_losses,
            "clean_losses": c_losses, "schedules": faulted["sched"],
            "loss_scale": faulted["scale"]}


def sentinel_warn(ledger):
    """29(d): under warn the NaN step reaches the masters through the
    Adam kernel, and the kernel's result equals its plain version's on
    the same inputs (the same NaN positions, the rest bit for bit)."""
    th = {"enabled": True, "policy": "warn", "warmup_steps": 100,
          "fault_injection": {"faults": [{"kind": "nan_grads", "step": 1}]}}
    eng = sentinel_engine(SENTINEL_MICRO, th=th)
    tokens = sentinel_tokens(SENTINEL_MICRO, seed=3)[0]
    ledger.reset()
    eng.train_batch(batch=(tokens, tokens))
    seen = {}
    update = eng.optimizer.update

    def capture(grads, state, master, lr=None, compute_out=None,
                use_kernel=True):
        seen.update(grads=grads.clone(), state=state._replace(
            exp_avg=state.exp_avg.clone(),
            exp_avg_sq=state.exp_avg_sq.clone()), master=master.clone(),
            out=None if compute_out is None else compute_out.clone(),
            lr=lr, use_kernel=use_kernel)
        return update(grads, state, master, lr=lr, compute_out=compute_out,
                      use_kernel=use_kernel)

    eng.optimizer.update = capture
    eng.train_batch(batch=(tokens, tokens))
    torch.cuda.synchronize()
    ledger.check("train-sentinel warn", 2, 2)
    if not seen.get("use_kernel") or eng.sentinel.anomalies != 1 or \
            eng.sentinel.quarantined or eng.global_steps != 2:
        fail(f"warn: kernel {seen.get('use_kernel')}, anomalies "
             f"{eng.sentinel.anomalies}, quarantined "
             f"{eng.sentinel.quarantined}, steps {eng.global_steps}")
    state = update(seen["grads"], seen["state"], seen["master"],
                   lr=seen["lr"], compute_out=seen["out"], use_kernel=False)
    pairs = {"master": (eng._master, seen["master"]),
             "exp_avg": (eng.opt_state.exp_avg, state.exp_avg),
             "exp_avg_sq": (eng.opt_state.exp_avg_sq, state.exp_avg_sq),
             "params": (eng._params_flat, seen["out"])}
    nan = {}
    for name, (got, want) in pairs.items():
        same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
        rest = ~torch.isnan(want)
        if not same_nan or not torch.equal(got[rest], want[rest]):
            fail(f"warn: the Adam kernel's {name} differs from its plain "
                 f"version on the NaN step")
        nan[name] = int(torch.isnan(got).sum())
    if nan["master"] == 0:
        fail("warn: the NaN gradients did not reach the masters")
    del eng
    free_cuda()
    return {"nan_elements": nan, "num_params": seen["master"].numel()}


def sentinel_spike(ledger):
    """29(e): a x1e4 loss spike at serial 6 after a 3-step warm-up is one
    anomaly, "loss_spike", and the flags are clear on the next step."""
    th = {"enabled": True, "policy": "skip_batch", "warmup_steps": 3,
          "fault_injection": {"faults": [
              {"kind": "loss_spike", "step": 6, "factor": 1e4}]}}
    eng = sentinel_engine(SENTINEL_MICRO, th=th)
    batches = sentinel_tokens(SENTINEL_MICRO, 8, seed=4)
    ledger.reset()
    losses, flags = [], []
    for b in batches:
        losses.append(eng.train_batch(batch=(b, b)))
        flags.append(eng.sentinel.last_flags)
    ledger.check("train-sentinel loss spike", 8, 7)
    kinds = [w["kinds"] for w in eng.sentinel.quarantined_windows]
    if eng.sentinel.anomalies != 1 or kinds != [["loss_spike"]] or \
            flags[7] != 0 or not losses[6] > 100 * max(losses[:6]):
        fail(f"loss spike: anomalies {eng.sentinel.anomalies}, records "
             f"{kinds}, flags {flags}, losses {losses}")
    del eng
    free_cuda()
    return {"losses": losses, "flags": flags}


def sentinel_abort(ledger):
    """29(f): abort_after 2 with NaN gradients at serials 2-4 raises
    TrainingHealthError on the second anomaly (serial 3)."""
    from deeperspeed_tpu_torch import TrainingHealthError
    th = {"enabled": True, "policy": "abort", "abort_after": 2,
          "warmup_steps": 100, "fault_injection": {"faults": [
              {"kind": "nan_grads", "step": 2, "times": 3}]}}
    eng = sentinel_engine(SENTINEL_MICRO, th=th)
    tokens = sentinel_tokens(SENTINEL_MICRO, seed=5)[0]
    ledger.reset()
    done, error = 0, None
    try:
        for _ in range(5):
            eng.train_batch(batch=(tokens, tokens))
            done += 1
    except TrainingHealthError as e:
        error = str(e)
    ledger.check("train-sentinel abort", 4, 2)
    if error is None or done != 3 or "abort_after=2" not in error:
        fail(f"abort: {done} steps returned, error {error!r}")
    del eng
    free_cuda()
    return {"steps_returned": done, "error": error}


def sentinel_watchdog(ledger, tmp):
    """29(g): a 1.0 s deadline; the engine's first step (which includes
    the kernels' build when nothing was built before) stalls 2.5 s and
    must not fire; a 2.5 s stall at serial 3 fires exactly once with every
    thread's stack; with save_on_preemption a fire makes the next step
    boundary write a checkpoint that `latest` names and raise
    SystemExit."""
    from deeperspeed_tpu_torch.checkpoint import manifest as mf
    stall = {"kind": "stall", "seconds": SENTINEL_STALL_S}
    th = {"enabled": True, "hang_timeout_seconds": SENTINEL_HANG_S,
          "warmup_steps": 100, "fault_injection": {"faults": [
              dict(stall, step=0), dict(stall, step=3)]}}
    tokens = sentinel_tokens(SENTINEL_MICRO, seed=6)[0]
    eng = sentinel_engine(SENTINEL_MICRO, th=th)
    ledger.reset()
    step_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.train_batch(batch=(tokens, tokens))
        step_s.append(time.perf_counter() - t0)
        if len(step_s) == 1 and eng.sentinel.watchdog_fires:
            fail(f"the watchdog fired on the engine's first step "
                 f"({step_s[0]:.1f} s)")
    ledger.check("train-sentinel watchdog", 5, 5)
    dump = eng.sentinel.last_stack_dump or ""
    fires = eng.sentinel.watchdog_fires
    if fires != 1 or "train_batch" not in dump or "MainThread" not in dump:
        fail(f"watchdog: {fires} fires (want 1), dump has train_batch "
             f"{'train_batch' in dump}, MainThread {'MainThread' in dump}")
    del eng
    free_cuda()

    save_dir = os.path.join(tmp, "preemption")
    th["fault_injection"] = {"faults": [dict(stall, step=1)]}
    eng = sentinel_engine(SENTINEL_MICRO, th=th, ckpt={
        "save_dir": save_dir, "save_on_preemption": True})
    ledger.reset()
    eng.train_batch(batch=(tokens, tokens))
    code = None
    try:
        eng.train_batch(batch=(tokens, tokens))
    except SystemExit as e:
        code = e.code
    ledger.check("train-sentinel preemption", 2, 2)
    latest = mf.read_latest(save_dir)
    if code is None or eng.sentinel.watchdog_fires != 1 or \
            latest != "global_step2":
        fail(f"preemption: exit {code}, fires "
             f"{eng.sentinel.watchdog_fires}, latest {latest!r}")
    del eng
    free_cuda()
    return {"fires": fires, "step_s": step_s,
            "dump_lines": len(dump.splitlines()),
            "preemption_exit_code": code, "preemption_latest": latest}


def train_sentinel(fa, ad, report, profile_step=False):
    """Phase 29 on train-sentinel-125M (``profile_step``: 29(a) also
    profiles its off and on steps); checkpoints go to a temporary
    directory under build/, removed at the end."""
    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_sentinel_", dir="build")
    ledger = LaunchLedger(fa, ad)
    try:
        res = {"watchdog": sentinel_watchdog(ledger, tmp)}
        print(f"  (g) watchdog: first step {res['watchdog']['step_s'][0]:.2f}"
              f" s unarmed, {res['watchdog']['fires']} fire on the 2.5 s "
              f"stall, preemption save {res['watchdog']['preemption_latest']}"
              f" then SystemExit({res['watchdog']['preemption_exit_code']})",
              flush=True)
        res["rungs"] = {}
        for bs in SENTINEL_RUNGS:
            r = sentinel_rung(ledger, bs, tmp, profile_step)
            res["rungs"][f"bs{bs}"] = r
            med = r["step_ms_median"]
            print(f"  (a) bs {bs}: step {r['sentinel_step_ms_off']:.2f} ms "
                  f"off / {r['sentinel_step_ms_on']:.2f} ms on "
                  f"({r['sentinel_overhead_pct']:+.2f}%); medians of "
                  f"{SENTINEL_ROUNDS} alternating rounds {med['off']:.2f} / "
                  f"{med['on']:.2f} ({r['overhead_pct_median']:+.2f}%), "
                  f"warn (no read) {med['warn']:.2f} "
                  f"({r['overhead_pct_median_warn']:+.2f}%); recovery "
                  f"{r['sentinel_recovery_ms']:.1f} ms, rollbacks "
                  f"{r['sentinel_rollbacks']}", flush=True)
            for tag, pr in r.get("profile", {}).items():
                print_profile(f"bs {bs}, sentinel {tag}", pr,
                              report.get("card"))
        res["quarantine"] = sentinel_quarantine(ledger)
        print(f"  (b) quarantined step: launches "
              f"{res['quarantine']['launches_quarantined_step']}, next "
              f"{res['quarantine']['launches_next_step']}, state bit-equal",
              flush=True)
        res["trajectory"] = sentinel_trajectory(ledger, tmp)
        print("  (c) rollback trajectory bit-identical to the clean run",
              flush=True)
        res["warn"] = sentinel_warn(ledger)
        print(f"  (d) warn: NaN elements {res['warn']['nan_elements']}, the "
              f"kernel equal to its plain version", flush=True)
        res["spike"] = sentinel_spike(ledger)
        res["abort"] = sentinel_abort(ledger)
        print(f"  (e) loss spike flags {res['spike']['flags']}; (f) abort "
              f"after {res['abort']['steps_returned']} steps", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = dict(ledger.totals)
    res["design_launches"] = {k: {"mma": v, "fma": 0}
                              for k, v in ledger.design.items()}
    report["train_sentinel"] = res
    return res


# ---------------------------------------------------------------------------
# phase 30: sentinel parity, kernels vs plain path, fp32
# ---------------------------------------------------------------------------

def sentinel_parity_nan_steps():
    """The step serials phase 30's plan gives NaN gradients."""
    return {f["step"] + i
            for f in SENTINEL_PARITY_TH["fault_injection"]["faults"]
            if f["kind"] == "nan_grads" for i in range(f.get("times", 1))}


def sentinel_parity_run(tmp, tag, use_kernels, legacy):
    """Phase 30's plan through ``train_batch`` or the legacy loop (whose
    update has no injector and no loss: the planned NaN gradients are
    written into the accumulator before `step`)."""
    import deeperspeed_tpu_torch as dst
    save_dir = os.path.join(tmp, tag)
    conf = {**SENTINEL_BASE, "train_batch_size": 4,
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "fp16": {"enabled": False},
            "training_health": SENTINEL_PARITY_TH,
            "checkpoint": {"save_dir": save_dir}}
    model = build_model(torch.float32, seed=1,
                        num_layers=SENTINEL_PARITY_LAYERS)
    model.use_kernels = use_kernels
    eng, *_ = dst.initialize(model=model, config_params=conf)
    verdicts = []
    after = eng._after_step

    def recorded(*args):
        verdicts.append(after(*args))
        return verdicts[-1]

    eng._after_step = recorded
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(2, 2, TRAIN_SEQ))).cuda()
    nan_steps = sentinel_parity_nan_steps()
    losses = []
    for step in range(SENTINEL_PARITY_STEPS):
        if step == SENTINEL_PARITY_SAVE:
            eng.save_checkpoint(save_dir)
        if not legacy:
            losses.append(eng.train_batch(batch=(tokens, tokens)))
            continue
        for m in range(2):
            eng.backward(eng((tokens[m], tokens[m])))
        if step in nan_steps:
            eng._grad_acc.fill_(float("nan"))
        losses.append(eng.step())
    s = eng.sentinel
    out = {"verdicts": verdicts, "losses": losses,
           "counters": {"anomalies": s.anomalies,
                        "quarantined": s.quarantined,
                        "rollbacks": s.rollbacks,
                        "global_steps": eng.global_steps},
           "records": [dict(w) for w in s.quarantined_windows]}
    del eng
    free_cuda()
    return out


def sentinel_parity(report):
    """Phase 30: phase 29's model at 4 layers in fp32 (micro 2 x gas 2,
    clipping) under one fault plan through the kernels and through the
    plain path: identical verdicts, counters and quarantine records,
    losses within rtol 1e-4; the legacy loop on the same plan gives the
    verdicts of its gradient flags."""
    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_sentinel_parity_", dir="build")
    try:
        runs = {tag: sentinel_parity_run(tmp, tag, kernels, legacy)
                for tag, kernels, legacy in (("kernels", True, False),
                                             ("plain", False, False),
                                             ("legacy", True, True))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k, p, lg = runs["kernels"], runs["plain"], runs["legacy"]
    want = ["ok"] * 4 + ["quarantined"] + ["ok"] * 2 + \
        ["quarantined", "rollback", "ok"]
    fast, plain = np.array(k["losses"]), np.array(p["losses"])
    rel = float(np.max(np.abs(fast - plain) / np.abs(plain)))
    if k["verdicts"] != want or p["verdicts"] != want or \
            k["counters"] != p["counters"] or k["records"] != p["records"] \
            or not rel <= 1e-4:
        fail(f"sentinel parity: kernels {k['verdicts']} {k['counters']} vs "
             f"plain {p['verdicts']} {p['counters']} (want {want}), "
             f"records {k['records']} vs {p['records']}, loss rel {rel:.3e}")
    # the legacy loop sees no loss: only its NaN-gradient steps flag
    nan_steps = sentinel_parity_nan_steps()
    legacy_want = [v if i in nan_steps else "ok"
                   for i, v in enumerate(want)]
    if lg["verdicts"] != legacy_want:
        fail(f"sentinel parity: the legacy loop's verdicts "
             f"{lg['verdicts']} != {legacy_want}")
    report["train_sentinel_parity"] = {
        "verdicts": k["verdicts"], "legacy_verdicts": lg["verdicts"],
        "counters": k["counters"], "legacy_counters": lg["counters"],
        "records": k["records"], "kernels": k["losses"],
        "plain": p["losses"], "max_rel_diff": rel, "rtol": 1e-4}
    print(f"  verdicts {k['verdicts']} (plain identical; legacy "
          f"{lg['verdicts']}), counters {k['counters']}, losses max "
          f"relative difference {rel:.3e}", flush=True)


def serve_chaos_only(card):
    """Phases 27-28 alone."""
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s", flush=True)
    report = {"card": card}
    run_chaos_phases(fa, da, qm, report, card)
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_chaos.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    return 0


def run_sentinel_phases(fa, ad, report, card, profile_step=False):
    print(f"training under failure train-sentinel-125M (row_sentinel; bf16, "
          f"fp32 masters, ZeRO-2) on {card}:", flush=True)
    ts = train_sentinel(fa, ad, report, profile_step)
    print("sentinel parity (fp32, 4 layers, kernels vs plain, and the legacy "
          "loop):", flush=True)
    sentinel_parity(report)
    return ts


def sentinel_only(card, profile_step=False):
    """Phases 29-30 alone. Phase 29(g) runs first, so that its engine's
    first step includes the kernels' build."""
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    report = {"card": card}
    run_sentinel_phases(fa, ad, report, card, profile_step)
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s, inside phase 29(g)'s "
          f"first step", flush=True)
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_sentinel.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# fp16: phase 3's fp16 cases, phase 31 (fp16 training) and phase 32 (fp16
# serving)
# ---------------------------------------------------------------------------

# the fp16 kernels against their plain versions, as the bf16 ones: the
# kernel rounds its output to fp16 once after fp32 sums in another order
# and (flash) packs P and dS to fp16, where the plain version keeps them
# in fp32; fp16 carries 3 more mantissa bits than bf16, so these are
# bf16's bounds halved (the flash backward's dS at dO's full scale keeps
# bf16's)
TOL_FP16 = {"out": (1e-2, 1e-2), "lse": (1e-3, 0.0), "bwd": (3e-2, 3e-2),
            "decode": (5e-3, 5e-3), "gmm": 5e-3}
# fp16's overflow threshold: a value at or past it rounds to inf
FP16_INF_AT = 65520.0
# GPT-NeoX configs/125M.yml's fp16 block; initial_scale_power is left at
# its default, 32 (2^32), so the opening steps overflow and are skipped
FP16_BLOCK = {"enabled": True, "type": "float16", "loss_scale": 0,
              "loss_scale_window": 1000, "hysteresis": 2,
              "min_loss_scale": 1}
FP16_TRAIN_CONFIG = {**TRAIN_CONFIG, "fp16": FP16_BLOCK}
# train-fp16-125M runs until this many steps were taken (at most
# FP16_MAX_STEPS steps: every overflow from 2^32 down is skipped)
FP16_TAKEN = 14
FP16_MAX_STEPS = 64
# the short fp16 rungs (MoE, BERT with Lamb, the lean state, parity)
# start at 2^16, so that a few steps hold both skipped and taken ones
FP16_SHORT = {**FP16_BLOCK, "initial_scale_power": 16}
FP16_MOE_STEPS = 8
# the lean fp16 state: fp16 parameters as the masters and fp16 Adam
# moments (ZeRO stage 0: the JAX engine refuses the flag with ZeRO)
# eps 1e-4: fp16 holds no v = g^2 below 6e-8 (the second moment of a
# 1e-4 gradient underflows to 0, and m / eps at eps 1e-8 would step by
# 1e4)
FP16_LEAN_CONFIG = {**TRAIN_CONFIG, "zero_optimization": {"stage": 0},
                    "optimizer": {"type": "Adam", "params": {
                        **TRAIN_CONFIG["optimizer"]["params"],
                        "eps": 1e-4, "state_dtype": "float16"}},
                    "fp16": {**FP16_SHORT,
                             "fp16_master_weights_and_grads": True}}
FP16_LEAN_STEPS = 8
# train-bert-large-512-fp16-lamb: phase 15's BERT-large in fp16 with the
# DeepSpeedExamples bing_bert Lamb options, at phase 15's lr
FP16_BERT_STEPS = 6
FP16_BERT_CONFIG = {**BERT_TRAIN_CONFIG, "fp16": FP16_SHORT,
                    "optimizer": {"type": "Lamb", "params": {
                        "lr": BERT_TRAIN_CONFIG["optimizer"]["params"]["lr"],
                        "weight_decay": 0.01, "bias_correction": False,
                        "max_coeff": 0.3, "min_coeff": 0.01}}}
# phase 31(d): 125M widths at 4 layers, both paths in fp16 from 2^20, 10
# steps of micro 2 x gas 2; losses within rtol 2e-2 (the two paths round
# the fp16 activations apart, about 1e-3 a step, and Adam carries it on)
FP16_PARITY_LAYERS = 4
FP16_PARITY_STEPS = 10
FP16_PARITY_RTOL = 2e-2


def replay_loss_scale(init_scale, overflows, scale_window, min_scale,
                      hysteresis, scale_factor=2.0):
    """The JAX package's `update_loss_scale` rule
    (deeperspeed_tpu/runtime/fp16/loss_scaler.py:136), replayed on the
    host over observed overflow flags → the scale after each step."""
    scale, it, last, hyst, out = float(init_scale), 0, -1, hysteresis, []
    for overflow in overflows:
        if overflow:
            shift = hysteresis == 1 or hyst <= 1
            if shift:
                scale = max(scale / scale_factor, min_scale)
            else:
                hyst -= 1
            last = it
        elif (it - last) % scale_window == 0:
            scale *= scale_factor
            hyst = hysteresis
        it += 1
        out.append(scale)
    return out


def fp16_flash_case(fa, gen, B, S, H, D, seg=None, times=False):
    """The fp16 flash forward and backward kernels against their plain
    versions on one causal case (q, k, v split out of one projection) →
    row; with ``times``, timed beside the plain versions and SDPA."""
    import torch.nn.functional as F
    dtype = torch.float16
    q, k, v, seg_ids, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
    seg = seg_ids if seg else None
    out, lse = fa.flash_attention_cuda(q, k, v, seg)
    ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v, seg)
    torch.cuda.synchronize()
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": "fp16",
           "segments": seg is not None, "tol_out": TOL_FP16["out"],
           "tol_bwd": TOL_FP16["bwd"]}
    row["max_abs_err_out"], ok = close(out, ref_out, *TOL_FP16["out"])
    row["max_abs_err_lse"], ok_l = close(lse, ref_lse, *TOL_FP16["lse"])
    ok = ok and ok_l and out.dtype == dtype
    del ref_out, ref_lse
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    delta = fa.attention_delta(out, do)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, seg)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, seg)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        row[f"max_abs_err_{name}"], good = close(g, w, *TOL_FP16["bwd"])
        ok = ok and good and g.dtype == dtype
    print(f"  fp16 flash {row}", flush=True)
    if not ok:
        fail(f"the fp16 flash kernels disagree with their plain versions: "
             f"{row}")
    del got, want
    if times:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        # SDPA: is_causal, or (segments) the causal same-segment bool mask
        lib_kw = {"is_causal": True} if seg is None else {"attn_mask": (
            torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None]
            & (seg[:, :, None] == seg[:, None, :]))[:, None]}
        row["ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v, seg))
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_segmented_reference(q, k, v, seg),
            warmup=2, iters=10)
        with torch.no_grad():
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       **lib_kw))
        row["bound_ms"], row["bound_by"] = prefill_bound_ms(q, seg)
        row["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, lse, do, delta, seg))
        row["plain_bwd_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                     seg),
            warmup=2, iters=10)
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        do_t = do.transpose(1, 2).contiguous()
        row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do_t, retain_graph=True))
        row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bwd_bound_ms(q, seg)
        print(f"  fp16 flash times B={B} S={S} H={H} D={D}"
              f"{' ragged segments' if seg is not None else ''}: forward "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, SDPA "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.5f} "
              f"{row['bound_by']}), backward {row['bwd_ms']:.4f} ms (plain "
              f"{row['plain_bwd_ms']:.4f}, SDPA {row['library_bwd_ms']:.4f}"
              f", bound {row['bwd_bound_ms']:.5f} {row['bwd_bound_by']})",
              flush=True)
        del qt, kt, vt, o_lib, do_t
    del q, k, v, out, lse, do, delta
    torch.cuda.empty_cache()
    return row


def fp16_bert_case(fa, gen):
    """The fp16 flash kernels with the key-bias and dropout flags at
    BERT-large's shape (not causal, rate 0.1, the last batch row all
    masked) against their plain versions: exact zeros and lse +1e30 on
    the dead row, whose -1e30 bias stays in the kernels' fp32 kbias."""
    q, k, v, kbias, do, seed, lens = bert_attention_case(torch.float16, gen)
    B, S, H, D = q.shape
    flags = (None, None, None, False, kbias, seed, 0.1)
    out, lse = fa.flash_attention_cuda(q, k, v, *flags)
    ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v,
                                                              *flags)
    delta = fa.attention_delta(out, do)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta, *flags)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *flags)
    torch.cuda.synchronize()
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": "fp16", "rate": 0.1,
           "kbias": True, "tol_out": TOL_FP16["out"],
           "tol_bwd": TOL_FP16["bwd"]}
    row["max_abs_err_out"], ok = close(out, ref_out, *TOL_FP16["out"])
    row["max_abs_err_lse"], ok_l = close(lse, ref_lse, *TOL_FP16["lse"])
    ok = ok and ok_l
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        row[f"max_abs_err_{name}"], good = close(g, w, *TOL_FP16["bwd"])
        ok = ok and good
    row["dead_row_exact"] = bool((out[-1] == 0).all()) and \
        bool((lse[-H:] == 1e30).all()) and \
        all(bool((g[-1] == 0).all()) for g in got)
    print(f"  fp16 flash kbias/dropout {row}", flush=True)
    if not (ok and row["dead_row_exact"]):
        fail(f"the fp16 flagged flash kernels disagree with their plain "
             f"versions or the all-masked row is not exact: {row}")
    import torch.nn.functional as F
    row["ms"] = time_ms(lambda: fa.flash_attention_cuda(q, k, v, *flags))
    row["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, lse, do, delta, *flags))
    row["plain_ms"] = time_ms(lambda: fa.flash_attention_segmented_reference(
        q, k, v, *flags), warmup=2, iters=10)
    row["plain_bwd_ms"] = time_ms(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                 *flags), warmup=2, iters=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = kbias[:, None, None, :].to(torch.float16)
    with torch.no_grad():
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, dropout_p=0.1))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           dropout_p=0.1)
    do_t = do.transpose(1, 2).contiguous()
    row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    del o_lib, do_t
    pairs = int(lens.sum()) * S * H
    row["bound_ms"], row["bound_by"] = attn_bound_ms(q, pairs, "fwd",
                                                     extra_bytes=B * S * 4)
    row["bwd_bound_ms"], row["bwd_bound_by"] = attn_bound_ms(
        q, pairs, "bwd", extra_bytes=B * S * 4)
    print(f"  fp16 flash kbias/dropout times: forward {row['ms']:.4f} ms "
          f"(plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, "
          f"bound {row['bound_ms']:.5f} {row['bound_by']}), backward "
          f"{row['bwd_ms']:.4f} ms (plain {row['plain_bwd_ms']:.4f}, SDPA "
          f"{row['library_bwd_ms']:.4f}, bound {row['bwd_bound_ms']:.5f} "
          f"{row['bwd_bound_by']})", flush=True)
    del qt, kt, vt
    del q, k, v, out, lse, got, want, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


def overflow_placement(row, got, want, undecided):
    """Where the kernels' (dq, dk, dv) are non-finite against the plain
    version's, into ``row``, for the overflow cases (dO scaled on heads
    0-1 of batch row 0) → (the same places outside ``undecided``, where
    a last bit decides; dq and dk overflowed to inf; nothing non-finite
    off the scaled heads)."""
    same = True
    for name, g, w, u in zip(("dq", "dk", "dv"), got, want, undecided):
        gi, wi = ~torch.isfinite(g), ~torch.isfinite(w)
        row[f"{name}_nonfinite"] = int(gi.sum())
        row[f"{name}_nonfinite_plain"] = int(wi.sum())
        row[f"{name}_inf"] = int(torch.isinf(g).sum())
        row[f"{name}_undecided"] = int(u.sum())
        row[f"{name}_mismatched"] = int(((gi != wi) & ~u).sum())
        same = same and row[f"{name}_mismatched"] == 0
        row[f"{name}_nonfinite_elsewhere"] = int(gi.sum() -
                                                 gi[0, :, :2].sum())
    hit = row["dq_inf"] > 0 and row["dk_inf"] > 0
    clean = all(row[f"{n}_nonfinite_elsewhere"] == 0
                for n in ("dq", "dk", "dv"))
    return same, hit, clean


def fp16_overflow_case(fa, gen, B=2, S=256, H=4, D=64):
    """dO at fp16's full scale on heads 0-1 of batch row 0 (and v at 8x),
    so that dS = P∘(dP − delta)·scale passes 65504 on the early rows of
    those heads; the rest is an ordinary call. The kernels round dS to
    fp16 (inf past 65504) before dQ = dS·K and dK = dSᵀ·Q, as the plain
    version does: dq, dk, dv must be non-finite exactly where the plain
    version's are (leaving out the elements `fp16_overflow_undecided`
    marks: a value, or a dS entry of its row or key, within 1e-3 of the
    threshold, where a last bit decides), on those heads only, and the
    forward stays finite."""
    dtype = torch.float16
    q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
    v = (v.float() * 8).to(dtype)
    out, lse = fa.flash_attention_cuda(q, k, v)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda")
    do[0, :, :2] = (do[0, :, :2] * 20000).clamp(-60000, 60000)
    do = do.to(dtype)
    delta = fa.attention_delta(out, do)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, delta)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    undecided = fa.fp16_overflow_undecided(q, k, v, out, lse, do)
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": "fp16",
           "out_finite": bool(torch.isfinite(out).all())}
    same, hit, clean = overflow_placement(row, got, want, undecided)
    print(f"  fp16 flash backward overflow case {row}", flush=True)
    if not (row["out_finite"] and same and hit and clean):
        fail(f"fp16 overflow case: the kernels' non-finite gradients do not "
             f"sit exactly where the plain version's do: {row}")
    del q, k, v, out, lse, do, delta, got, want
    torch.cuda.empty_cache()
    return row


def fp16_decode_cases(da, gen):
    """The cluster decode over fp16 pools with fp16 q at the serving shape
    (B 16: clusters of 4) and at head dim 128 against its plain version
    (which rounds P to fp16 as JAX does), then timed over lengths 0-1024
    and 62-110 → (checked rows, timed rows)."""
    rows = []
    for shape in (dict(B=16, H=12, D=64, ps=64, NP=16, P=513),
                  dict(B=3, H=2, D=128, ps=16, NP=8, P=40)):
        q, table, lengths = decode_query_case(torch.float16, gen, **shape)
        pools = decode_pools(gen, 2, shape["P"], shape["H"], shape["ps"],
                             shape["D"], torch.float16, False)
        views = tuple(p[1] for p in pools)
        out = decode_call(da, q, views, table, lengths)
        again = decode_call(da, q, views, table, lengths)
        ref = decode_reference(da, q, views, table, lengths)
        torch.cuda.synchronize()
        err, ok = close(out, ref, *TOL_FP16["decode"])
        row = {"dtype": "fp16", "max_abs_err": err,
               "tol": TOL_FP16["decode"],
               "design": da.kernel_design(q, views[0]),
               "cluster": da.launch_plan(shape["B"], shape["H"],
                                         shape["NP"]),
               "two_calls_identical": torch.equal(out, again),
               "zero_rows_exact": bool((out[lengths == 0] == 0).all()),
               **shape}
        print(f"  paged_decode fp16 {row}", flush=True)
        if not (ok and row["design"] == "cluster" and
                row["two_calls_identical"] and row["zero_rows_exact"] and
                out.dtype == torch.float16):
            fail(f"the fp16 cluster decode disagrees with its plain version:"
                 f" {row}")
        rows.append(row)
        del pools, views
    timed = [decode_times(da, gen, False, serving, dtype=torch.float16)
             for serving in (False, True)]
    return rows, timed


def fp16_gmm_cases(gm, gen):
    """The grouped forward, dx and dW in fp16 at phase 11's geometry
    against their plain versions (dead rows exact zeros, the empty
    expert's dW exact zeros), timed beside torch.bmm."""
    rows = []
    for K, N in GMM_SHAPES:
        row, (x, w, dy, sz) = gmm_case(gm, gen, GMM_SIZES, GMM_SPAN, K, N,
                                       len(GMM_SIZES), None, torch.float16)
        gmm_times(gm, row, x, w, dy, sz)
        rows.append(row)
        del x, w, dy, sz
        torch.cuda.empty_cache()
    return rows


def fp16_adam_cases(ad, gen, n):
    """The flat Adam kernel's fp16 variants at the model's parameter count:
    classic (fp32 p, m, v, fp32 g as the engine hands it after unscaling,
    the fp16 copy written in the same pass; within TOL_ADAM, the copy the
    new p rounded) and lean (fp16 p, m, v, fp32 g; bit-equal), each timed
    beside its plain version and AdamW(fused=True) in the same storage."""
    hp = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
    rows = {}
    for lean in (False, True):
        pdt = torch.float16 if lean else torch.float32
        p = torch.randn(n, generator=gen, device="cuda").to(pdt)
        g = (1e-3 * torch.randn(n, generator=gen, device="cuda"))
        m = (1e-3 * torch.randn(n, generator=gen, device="cuda")).to(pdt)
        v = (1e-6 * torch.rand(n, generator=gen, device="cuda")).to(pdt)
        want = ad.adam_flat_reference(p, g, m, v, 6e-4, 3, **hp)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        copy = None if lean else torch.empty(n, dtype=torch.float16,
                                             device="cuda")
        ad.reset_launches()
        ad.adam_cuda(pk, g, mk, vk, 6e-4, 3, adam_w=True,
                     bias_correction=True, p_out=copy, **hp)
        torch.cuda.synchronize()
        tag = "lean" if lean else "classic"
        row = {"n": n, "variant": dict(ad.variant_launches),
               "storage": "fp16 p, m, v; fp32 g" if lean else
               "fp32 p, m, v; fp32 g; fp16 copy"}
        ok = True
        for name, got, ref in (("p", pk, want[0]), ("m", mk, want[1]),
                               ("v", vk, want[2])):
            if lean:
                row[f"bit_equal_{name}"] = bool(torch.equal(got, ref))
                ok = ok and row[f"bit_equal_{name}"]
                row[f"max_abs_err_{name}"] = float(
                    (got.float() - ref.float()).abs().max())
            else:
                err, good = close(got, ref, *TOL_ADAM)
                row[f"max_abs_err_{name}"] = err
                ok = ok and good
        if not lean:
            row["fp16_copy_is_recast"] = bool(torch.equal(
                copy, pk.to(torch.float16)))
            ok = ok and row["fp16_copy_is_recast"]
        want_variant = {"fp16 lean" if lean else "fp16 classic": 1}
        print(f"  adam fp16 {tag} {row}", flush=True)
        if not ok or row["variant"] != want_variant:
            fail(f"the fp16 {tag} Adam kernel disagrees with its plain "
                 f"version: {row}")
        del want
        row["ms"] = time_ms(lambda: ad.adam_cuda(
            pk, g, mk, vk, 6e-4, 3, adam_w=True, bias_correction=True,
            p_out=copy, **hp))
        row["plain_ms"] = time_ms(lambda: ad.adam_flat_reference(
            p, g, m, v, 6e-4, 3, **hp), warmup=2, iters=10)
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.to(pdt)
        lib = torch.optim.AdamW([lib_p], lr=6e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.01, fused=True)
        row["library_ms"] = time_ms(lib.step)
        row["library"] = (f"AdamW(fused=True) on one flat "
                          f"{'fp16' if lean else 'fp32'} tensor")
        esz = p.element_size()
        nbytes = n * (6 * esz + g.element_size() + (0 if lean else 2))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 14 * n)
        print(f"  adam fp16 {tag} times n={n}: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
        rows[tag] = row
        del p, g, m, v, pk, mk, vk, copy, lib_p, lib
        torch.cuda.empty_cache()
    return rows


def fp16_sparse_case(bsa, fa, gen):
    """The three block-sparse kernels in fp16 at phase 13's attention
    shape (B=2, S=16384, H=12, D=64, fixed l16g1 causal) against their
    plain versions (TOL_FP16 out / bwd; dq, dk, dv also through the
    autograd function), two calls of each bit-identical, every launch
    "mma"; timed beside the plain versions, SDPA in fp16 under the bool
    token mask and the bound; then a causal D 128 case (B=2, S=2048, H=4,
    l4g1) and an overflowing loss-scaled backward at S 1024."""
    B, S, H, D, dtype = 2, SPARSE_SEQ, 12, 64, torch.float16
    layout = sparse_layout(SPARSE_L16G1, S)
    luts = bsa.LayoutLuts(layout)
    pairs = sparse_live_pairs(layout, True, B)
    lut_bytes = sum(a.nbytes for a in luts.fwd + luts.bwd)
    bsa.reset_design_launches()
    q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
    out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, True)
    ref_out, ref_lse = bsa.block_sparse_attention_reference(q, k, v, luts,
                                                            True)
    torch.cuda.synchronize()
    err_o, ok_o = close(out, ref_out, *TOL_FP16["out"])
    err_l, ok_l = close(lse, ref_lse, *TOL_FP16["lse"])
    del ref_out, ref_lse
    grads, ok_g, (do, delta) = check_sparse_grads(
        bsa, fa, q, k, v, luts, True, out, lse, gen, tol=TOL_FP16["bwd"])
    row = {"B": B, "S": S, "H": H, "D": D, "dtype": "fp16",
           "layout": "fixed l16g1 causal", "live_pairs": pairs,
           "max_abs_err_out": err_o, "max_abs_err_lse": err_l,
           "tol_out": TOL_FP16["out"], "tol_bwd": TOL_FP16["bwd"], **grads}
    print(f"  block_sparse fp16 {row}", flush=True)
    if not (ok_o and ok_l and ok_g and out.dtype == dtype):
        fail(f"the fp16 block-sparse kernels disagree with their plain "
             f"versions: {row}")
    row.update(sparse_bit_identity(bsa, q, k, v, lse, do, delta, luts,
                                   True))
    row["design_launches"] = {p: dict(c)
                              for p, c in bsa.design_launches.items()}
    if any(c["fma"] for c in bsa.design_launches.values()):
        fail(f"an fp16 block-sparse launch at D 64 took the FMA design: "
             f"{row['design_launches']}")
    row["fwd_ms"] = time_ms(lambda: bsa.block_sparse_attention_cuda(
        q, k, v, luts, True), warmup=2, iters=10)
    row["dkv_ms"] = time_ms(lambda: bsa.block_sparse_attention_dkv_cuda(
        q, k, v, lse, do, delta, luts, True), warmup=2, iters=10)
    row["dq_ms"] = time_ms(lambda: bsa.block_sparse_attention_dq_cuda(
        q, k, v, lse, do, delta, luts, True), warmup=2, iters=10)
    row["plain_fwd_ms"] = time_ms(
        lambda: bsa.block_sparse_attention_reference(q, k, v, luts, True),
        warmup=1, iters=3)
    row["plain_bwd_ms"] = time_ms(
        lambda: bsa.block_sparse_attention_bwd_reference(
            q, k, v, out, lse, do, luts, True), warmup=1, iters=3)
    for part in ("fwd", "dkv", "dq"):
        row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = \
            attn_bound_ms(q, pairs, part, lut_bytes)
    mask = token_mask(layout, True)
    row["library_fwd_ms"], row["library_bwd_ms"], row["library_batch"] = \
        sdpa_times(q, k, v, do, mask)
    del mask
    print(f"  block_sparse times (fp16): forward {row['fwd_ms']:.4f} ms, "
          f"dk/dv {row['dkv_ms']:.4f} ms, dq {row['dq_ms']:.4f} ms; plain "
          f"{row['plain_fwd_ms']:.4f} / {row['plain_bwd_ms']:.4f} ms; SDPA "
          f"(fp16, bool mask, B={row['library_batch']}) "
          f"{row['library_fwd_ms']:.4f} / {row['library_bwd_ms']:.4f} ms; "
          f"bounds {row['fwd_bound_ms']:.5f} / {row['dkv_bound_ms']:.5f} / "
          f"{row['dq_bound_ms']:.5f} ms ({row['fwd_bound_by']})", flush=True)
    del q, k, v, out, lse, do, delta
    torch.cuda.empty_cache()
    # causal D 128
    B2, S2, H2 = 2, 2048, 4
    luts2 = bsa.LayoutLuts(sparse_layout(SPARSE_L4G1, S2, H=H2))
    q, k, v, _, _ = prefill_case(S2, dtype, gen, B=B2, H=H2, D=128)
    out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts2, True)
    ref_out, _ = bsa.block_sparse_attention_reference(q, k, v, luts2, True)
    err, ok = close(out, ref_out, *TOL_FP16["out"])
    g128, ok_g, (do, delta) = check_sparse_grads(
        bsa, fa, q, k, v, luts2, True, out, lse, gen, tol=TOL_FP16["bwd"])
    row["d128"] = {"B": B2, "S": S2, "H": H2, "max_abs_err_out": err,
                   **g128, **sparse_bit_identity(bsa, q, k, v, lse, do,
                                                 delta, luts2, True)}
    print(f"  block_sparse fp16 causal D=128 {row['d128']}", flush=True)
    if not (ok and ok_g):
        fail(f"the fp16 block-sparse kernels disagree at D 128: "
             f"{row['d128']}")
    del q, k, v, out, lse, do, delta, ref_out
    row["overflow"] = fp16_sparse_overflow_case(bsa, fa, gen)
    torch.cuda.empty_cache()
    return row


def fp16_sparse_overflow_case(bsa, fa, gen, B=2, S=1024, H=4, D=64):
    """dO at fp16's full scale on heads 0-1 of batch row 0 and v at 8x, on
    a causal l4g1 layout: the kernels' non-finite dq, dk, dv sit where the
    plain version's do, leaving out what `fp16_overflow_undecided` marks
    (with the layout), on those heads only; the forward stays finite."""
    dtype = torch.float16
    layout = sparse_layout(SPARSE_L4G1, S, H=H)
    luts = bsa.LayoutLuts(layout)
    q, k, v, _, _ = prefill_case(S, dtype, gen, B=B, H=H, D=D)
    v = (v.float() * 8).to(dtype)
    out, lse = bsa.block_sparse_attention_cuda(q, k, v, luts, True)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda")
    do[0, :, :2] = (do[0, :, :2] * 20000).clamp(-60000, 60000)
    do = do.to(dtype)
    delta = fa.attention_delta(out, do)
    got = bsa.block_sparse_attention_bwd_cuda(q, k, v, lse, do, delta, luts,
                                              True)
    want = bsa.block_sparse_attention_bwd_reference(q, k, v, out, lse, do,
                                                    luts, True)
    torch.cuda.synchronize()
    undecided = fa.fp16_overflow_undecided(
        q, k, v, out, lse, do,
        layout=torch.as_tensor(np.asarray(layout) != 0, device="cuda"))
    row = {"B": B, "S": S, "H": H, "D": D, "layout": "fixed l4g1 causal",
           "out_finite": bool(torch.isfinite(out).all())}
    same, _, clean = overflow_placement(row, got, want, undecided)
    print(f"  block_sparse fp16 backward overflow case {row}", flush=True)
    if not (row["out_finite"] and same and clean and row["dq_nonfinite"]
            and row["dk_nonfinite"]):
        fail(f"fp16 block-sparse overflow case: the kernels' non-finite "
             f"gradients do not sit where the plain version's do: {row}")
    del q, k, v, out, lse, do, delta, got, want
    return row


def fp16_qmm_cases(qm, gen):
    """The int8 matmul with fp16 activations (the wgmma kernel) against its
    plain version within TOL_QMM[fp16] of max|ref|: the four block
    weights at M = 16, 256 and 4096, two calls bit-identical, mlp-in and
    mlp-out timed (events and CUDA graphs) beside the plain version,
    `torch.matmul` on the dequantized fp16 weight and the bound; the
    widening read out bit for bit; an output past 65504 inf exactly where
    the plain version's is; every launch "wgmma"."""
    rows, identical = [], True
    qm.reset_design_launches()
    for M in QMM_PATH_ROWS + (4096,):
        for K, N in QMM_BLOCK_SHAPES:
            row, x, qw = qmm_case(qm, gen, M, K, N, torch.float16)
            again = qm.quant_matmul_cuda(x, qw)
            row["bit_identical"] = bool(torch.equal(
                qm.quant_matmul_cuda(x, qw), again))
            identical &= row["bit_identical"]
            if (K, N) in QMM_SHAPES:
                qmm_times(qm, gen, row, x, qw)
            rows.append(row)
            del x, qw
        torch.cuda.empty_cache()
    readout = {M: qmm_readout(qm, gen, M, dtype=torch.float16)
               for M in QMM_PATH_ROWS + (4096,)}
    # overflow: columns scaled so that their outputs pass 65504
    x = torch.randn(16, 768, generator=gen, device="cuda").to(torch.float16)
    qw = qm.quantize_weight(0.02 * torch.randn(768, 3072, generator=gen,
                                               device="cuda"))
    qw.scale[::3] *= 4e5
    got, want = qm.quant_matmul_cuda(x, qw), qm.quant_matmul_reference(x, qw)
    y = torch.matmul(x.float(), qw.qval.float()) * qw.scale
    # a sum within 1e-3 of the threshold may round either way by its order
    near = (y.abs() - FP16_INF_AT).abs() <= 1e-3 * FP16_INF_AT
    mism = int(((torch.isinf(got) != torch.isinf(want)) & ~near).sum())
    overflow = {"inf_plain": int(torch.isinf(want).sum()),
                "inf_kernel": int(torch.isinf(got).sum()),
                "mismatched": mism}
    design = dict(qm.design_launches)
    print(f"  quant_matmul fp16: widening readout mismatches {readout}; two "
          f"calls bit-identical {identical}; overflow {overflow}; launches "
          f"by design {design}", flush=True)
    if any(readout.values()) or not identical or mism or \
            not overflow["inf_plain"] or design["fma"]:
        fail(f"the fp16 int8 matmul kernel: readout {readout}, two calls "
             f"bit-identical {identical}, overflow {overflow}, designs "
             f"{design}")
    return {"rows": rows, "readout_mismatches": readout,
            "bit_identical": identical, "overflow": overflow,
            "design_launches": design}


def fp16_int8_decode_cases(da, gen):
    """The cluster decode over int8 pools (bf16 scales) with fp16 q at the
    serving shape (B 16) and at head dim 128 against its plain version
    (TOL_FP16 decode), then timed over lengths 0-1024 and 62-110 beside
    the single-block kernel, the plain version and SDPA on gathered,
    dequantized fp16 K/V → (checked rows, timed rows)."""
    rows = []
    for shape in (dict(B=16, H=12, D=64, ps=64, NP=16, P=513),
                  dict(B=3, H=2, D=128, ps=16, NP=8, P=40)):
        q, table, lengths = decode_query_case(torch.float16, gen, **shape)
        pools = decode_pools(gen, 2, shape["P"], shape["H"], shape["ps"],
                             shape["D"], torch.float16, True)
        views = tuple(p[1] for p in pools)
        out = decode_call(da, q, views, table, lengths)
        again = decode_call(da, q, views, table, lengths)
        ref = decode_reference(da, q, views, table, lengths)
        torch.cuda.synchronize()
        err, ok = close(out, ref, *TOL_FP16["decode"])
        row = {"dtype": "fp16 q, int8 pools", "max_abs_err": err,
               "tol": TOL_FP16["decode"],
               "design": da.kernel_design(q, views[0]),
               "cluster": da.launch_plan(shape["B"], shape["H"],
                                         shape["NP"]),
               "two_calls_identical": torch.equal(out, again),
               "zero_rows_exact": bool((out[lengths == 0] == 0).all()),
               **shape}
        print(f"  paged_decode_int8 fp16 {row}", flush=True)
        if not (ok and row["design"] == "cluster" and
                row["two_calls_identical"] and row["zero_rows_exact"] and
                out.dtype == torch.float16):
            fail(f"the fp16-q int8 decode disagrees with its plain version: "
                 f"{row}")
        rows.append(row)
        del pools, views
    timed = [decode_times(da, gen, True, serving, dtype=torch.float16)
             for serving in (False, True)]
    return rows, timed


def check_fp16_kernels(fa, da, gm, ad, bsa, qm, gen, report, n_params):
    """Phase 3's fp16 cases: every fp16 variant against its plain version
    in fp16 at the phase's shapes, timed beside its plain version, a
    library call and its bound."""
    B, S, H = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], TRAIN_SEQ, \
        NEOX_125M["num_heads"]
    res = {"flash_train": fp16_flash_case(fa, gen, B, S, H, 64, times=True),
           "flash_d128": fp16_flash_case(fa, gen, 4, S, H, 128),
           "flash_segments": fp16_flash_case(fa, gen, 4, S, H, 64,
                                             seg=True, times=True),
           "flash_bert": fp16_bert_case(fa, gen),
           "flash_overflow": fp16_overflow_case(fa, gen)}
    res["decode_checked"], res["decode_timed"] = fp16_decode_cases(da, gen)
    res["grouped_matmul"] = fp16_gmm_cases(gm, gen)
    res["adam"] = fp16_adam_cases(ad, gen, n_params)
    res["block_sparse"] = fp16_sparse_case(bsa, fa, gen)
    res["quant_matmul"] = fp16_qmm_cases(qm, gen)
    res["decode_int8_checked"], res["decode_int8_timed"] = \
        fp16_int8_decode_cases(da, gen)
    report["fp16_kernels"] = res
    return res


def fp16_engine(conf, model=None):
    import deeperspeed_tpu_torch as dst
    model = build_model(torch.float32) if model is None else model
    eng, *_ = dst.initialize(model=model, config_params=conf)
    if eng.compute_dtype != torch.float16:
        fail(f"the fp16 block did not give an fp16 engine: "
             f"{eng.compute_dtype}")
    return eng, model


def fp16_steps(eng, batch, max_steps, want_taken=None):
    """``train_batch`` until ``want_taken`` steps were taken (or
    ``max_steps`` ran) → (losses, overflow flags, scales after each step,
    step seconds)."""
    losses, overflows, scales, step_s = [], [], [], []
    while len(losses) < max_steps and (
            want_taken is None or overflows.count(False) < want_taken):
        skipped = eng.skipped_steps
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=batch))
        step_s.append(time.perf_counter() - t0)
        overflows.append(eng.skipped_steps > skipped)
        scales.append(float(eng.loss_scale))
        print(f"  step {len(losses)}: loss {losses[-1]:.4f}, "
              f"{'overflow, skipped' if overflows[-1] else 'taken'}, loss "
              f"scale now {scales[-1]:g}, {step_s[-1] * 1e3:.1f} ms",
              flush=True)
    return losses, overflows, scales, step_s


def check_scale_replay(what, conf, overflows, scales):
    block = conf["fp16"]
    replay = replay_loss_scale(
        2 ** block.get("initial_scale_power", 32), overflows,
        block["loss_scale_window"], block["min_loss_scale"],
        block["hysteresis"])
    if replay != scales:
        fail(f"{what}: the loss-scale trajectory {scales} is not the JAX "
             f"rule's replay {replay} over the overflow flags {overflows}")
    return replay


def neox_ftok(cfg, seq):
    """Model flops a token of GPT-NeoX (bench.py row_gpt2xl's formula):
    6N + 12·L·h·S."""
    return 6 * cfg.num_params() + 12 * cfg.num_layers * cfg.hidden_size * seq


def train_fp16(fa, ad, report, bf16=None, profile_step=False):
    """Phase 31(a), train-fp16-125M: phase 7's model, batch and config
    with GPT-NeoX configs/125M.yml's fp16 block (from 2^32) through
    `train_batch`: the opening overflows are skipped (no Adam launch),
    then FP16_TAKEN steps are taken on the classic fp16 Adam variant;
    the scale follows the JAX rule's replay and the loss falls. ``bf16``
    is phase 7's result, where it ran, for the MFU beside it; with
    ``profile_step``, two more taken steps under the profiler."""
    eng, model = fp16_engine(FP16_TRAIN_CONFIG)
    gas = eng.gradient_accumulation_steps()
    micro = eng.train_micro_batch_size_per_gpu()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
    L = model.config.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.reset_design_launches()
    ad.reset_launches()
    losses, overflows, scales, step_s = fp16_steps(
        eng, (tokens, tokens), FP16_MAX_STEPS, FP16_TAKEN)
    n, taken = len(losses), overflows.count(False)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
                "flash_bwd_dq": fa.bwd_dq_launches, "adam": ad.launches}
    want = {"flash_fwd": L * gas * n, "flash_bwd_dkv": L * gas * n,
            "flash_bwd_dq": L * gas * n, "adam": taken}
    if launches != want:
        fail(f"train-fp16-125M launch counts {launches} != {want} ({n} "
             f"steps, {taken} taken: one Adam a taken step)")
    if dict(ad.variant_launches) != {"fp16 classic": taken}:
        fail(f"train-fp16-125M Adam launches by variant "
             f"{ad.variant_launches}, want all {taken} fp16 classic")
    design = check_design(fa, "train_fp16", {
        "fwd": launches["flash_fwd"], "dkv": launches["flash_bwd_dkv"],
        "dq": launches["flash_bwd_dq"]})
    replay = check_scale_replay("train-fp16-125M", FP16_TRAIN_CONFIG,
                                overflows, scales)
    taken_losses = [l for l, o in zip(losses, overflows) if not o]
    if not (overflows[0] and taken >= FP16_TAKEN and
            eng.skipped_steps == n - taken and eng.global_steps == taken):
        fail(f"train-fp16-125M: overflows {overflows}, {eng.global_steps} "
             f"global steps, {eng.skipped_steps} skipped (want the opening "
             f"steps skipped, then {FP16_TAKEN} taken)")
    if not (all(np.isfinite(taken_losses)) and
            taken_losses[-1] < 0.9 * taken_losses[0]):
        fail(f"train-fp16-125M: the loss did not fall over the taken steps: "
             f"{taken_losses}")
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median([t for t, o in zip(step_s, overflows) if not o]))
    tps = gas * micro * TRAIN_SEQ / med
    ftok = neox_ftok(model.config, TRAIN_SEQ)
    res = {"steps": n, "taken": taken, "skipped_steps": eng.skipped_steps,
           "overflows": overflows, "loss_scale": scales,
           "loss_scale_replay": replay, "losses": losses,
           "taken_losses": taken_losses, "step_ms_median": med * 1e3,
           "step_ms": [t * 1e3 for t in step_s], "tokens_per_s": tps,
           "mfu": tps * ftok / PEAK_FLOPS_S,
           "max_memory_allocated_gb": peak / 2 ** 30,
           "launches": launches, "design_launches": design,
           "adam_variants": dict(ad.variant_launches),
           "dtypes": {"compute": str(eng.compute_dtype),
                      "master": str(eng._master.dtype)}}
    if bf16 is not None:
        res["bf16_step_ms_median"] = bf16["step_ms_median"]
        res["bf16_tokens_per_s"] = bf16["tokens_per_s"]
        res["bf16_mfu"] = bf16["tokens_per_s"] * ftok / PEAK_FLOPS_S
    print(f"  {n} steps, {taken} taken, {eng.skipped_steps} skipped; loss "
          f"scale {scales[0]:g} -> {scales[-1]:g} (the JAX rule's replay); "
          f"taken losses {taken_losses[0]:.4f} -> {taken_losses[-1]:.4f}; "
          f"median taken step {med * 1e3:.1f} ms, {tps:.0f} tokens/s, MFU "
          f"{res['mfu']:.4f}" + (
              f" (bf16, phase 7: {bf16['step_ms_median']:.1f} ms, MFU "
              f"{res['bf16_mfu']:.4f})" if bf16 is not None else "") +
          f", peak memory {res['max_memory_allocated_gb']:.2f} GiB",
          flush=True)
    if profile_step:
        res["profile"] = profile_window(
            lambda: eng.train_batch(batch=(tokens, tokens)), 2,
            share_of="flash", also=("adam",))
        print_profile("fp16 training step (gas 2 x micro 16 x 1024)",
                      res["profile"], torch.cuda.get_device_name(0))
    report["train_fp16"] = res
    del eng, model
    torch.cuda.empty_cache()
    return res


def train_fp16_short(fa, ad, report, key, conf, steps, model=None, gm=None,
                     bert=False, lean=False):
    """Phase 31(b) (MoE, with ``gm``), (c) (BERT with Lamb) and (e) (the
    lean fp16 state): ``steps`` fp16 steps from 2^16 → result; every
    flash launch on the tensor cores, the grouped launches on wgmma, one
    Adam launch a taken step (none with Lamb), the scale the JAX rule's
    replay."""
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    eng, model = fp16_engine(conf, model)
    gas = eng.gradient_accumulation_steps()
    micro = eng.train_micro_batch_size_per_gpu()
    L = model.config.num_layers
    if bert:
        batch = bert_batch(1, micro, BERT_SEQ, model.config.vocab_size)
    else:
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(
            0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
        batch = (tokens, tokens)
    reset_attention_counts(fa, bsa)
    ad.reset_launches()
    if gm is not None:
        gm.launches = gm.dw_launches = 0
        gm.reset_design_launches()
    losses, overflows, scales, step_s = fp16_steps(eng, batch, steps)
    taken = overflows.count(False)
    counts = attention_counts(fa, bsa)
    flash = {k: counts[f"flash_{k}_kbias_dropout" if bert else
                       {"fwd": "flash_fwd", "dkv": "flash_bwd_dkv",
                        "dq": "flash_bwd_dq"}[k]]
             for k in ("fwd", "dkv", "dq")}
    want_flash = L * gas * steps
    launches = {"flash": flash, "adam": ad.launches}
    if flash != dict.fromkeys(("fwd", "dkv", "dq"), want_flash):
        fail(f"{key}: flash launches {flash}, want {want_flash} each")
    design = check_design(fa, key, flash)
    want_adam = 0 if bert else taken
    variant = "fp16 lean" if lean else "fp16 classic"
    if ad.launches != want_adam or (want_adam and dict(
            ad.variant_launches) != {variant: want_adam}):
        fail(f"{key}: Adam launches {ad.launches} by variant "
             f"{ad.variant_launches}, want {want_adam} ({variant})")
    if gm is not None:
        launches.update(grouped_matmul=gm.launches,
                        grouped_matmul_dw=gm.dw_launches)
        want_g = {"grouped_matmul": 4 * L * gas * steps,
                  "grouped_matmul_dw": 2 * L * gas * steps}
        design["grouped_matmul"] = dict(gm.design_launches)
        design["grouped_matmul_dw"] = dict(gm.dw_design_launches)
        for name, n in want_g.items():
            if launches[name] != n or design[name] != {"wgmma": n, "fma": 0}:
                fail(f"{key}: {name} launches {launches[name]} by design "
                     f"{design[name]}, want all {n} on wgmma")
    replay = check_scale_replay(key, conf, overflows, scales)
    taken_losses = [x for x, o in zip(losses, overflows) if not o]
    if taken < 2 or not all(np.isfinite(taken_losses)):
        fail(f"{key}: {taken} steps taken of {steps}, losses {losses}")
    med = float(np.median(step_s))
    res = {"steps": steps, "taken": taken, "overflows": overflows,
           "loss_scale": scales, "loss_scale_replay": replay,
           "losses": losses, "taken_losses": taken_losses,
           "step_ms_median": med * 1e3, "launches": launches,
           "design_launches": design,
           "adam_variants": dict(ad.variant_launches),
           "optimizer": type(eng.optimizer).__name__,
           "num_params": eng.num_params,
           "dtypes": {"compute": str(eng.compute_dtype),
                      "master": str(eng._master.dtype),
                      "moments": str(eng.opt_state.exp_avg.dtype)}}
    print(f"  {key}: {steps} steps, {taken} taken, loss scale "
          f"{scales[0]:g} -> {scales[-1]:g}, taken losses "
          f"{[round(x, 4) for x in taken_losses]}, median step "
          f"{med * 1e3:.1f} ms, {eng.num_params} parameters, "
          f"{res['optimizer']}, dtypes {res['dtypes']}", flush=True)
    report[key] = res
    del eng, model
    torch.cuda.empty_cache()
    return res


def train_fp16_legacy(fa, ad, report, steps=3):
    """Phase 31(f): phase 7's model and batch in fp16 (from 2^16) for
    ``steps`` steps through the legacy forward / backward / step loop and
    through `train_batch` on two fresh engines: losses, masters, the
    scale and the Adam launches equal bit for bit."""
    conf = {**FP16_TRAIN_CONFIG, "fp16": FP16_SHORT}
    rng = np.random.default_rng(0)
    runs = {}
    for legacy in (False, True):
        eng, model = fp16_engine(conf)
        gas = eng.gradient_accumulation_steps()
        micro = eng.train_micro_batch_size_per_gpu()
        tokens = torch.from_numpy(rng.integers(
            0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda() \
            if not runs else runs[False]["tokens"]
        ad.reset_launches()
        losses = []
        for _ in range(steps):
            if legacy:
                for i in range(gas):
                    eng.backward(eng((tokens[i], tokens[i])))
                    got = eng.step()
                losses.append(got)
            else:
                losses.append(eng.train_batch(batch=(tokens, tokens)))
        runs[legacy] = {"tokens": tokens, "losses": losses,
                        "master": eng._master.clone(),
                        "scale": float(eng.loss_scale),
                        "skipped": eng.skipped_steps,
                        "adam": dict(ad.variant_launches)}
        del eng, model
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    res = {"train_batch": a["losses"], "legacy": b["losses"],
           "masters_equal": bool(torch.equal(a["master"], b["master"])),
           "scale": [a["scale"], b["scale"]],
           "skipped": [a["skipped"], b["skipped"]],
           "adam": [a["adam"], b["adam"]]}
    report["train_fp16_legacy"] = res
    print(f"  legacy loop vs train_batch, {steps} fp16 steps: losses "
          f"{b['losses']} vs {a['losses']}, masters equal "
          f"{res['masters_equal']}, Adam {b['adam']} vs {a['adam']}",
          flush=True)
    if not (a["losses"] == b["losses"] and res["masters_equal"] and
            a["scale"] == b["scale"] and a["skipped"] == b["skipped"] and
            a["adam"] == b["adam"] and a["adam"]):
        fail(f"fp16 legacy loop differs from train_batch: {res}")
    return res


def train_fp16_parity(report):
    """Phase 31(d): 125M widths at 4 layers, fp16 from 2^20 through the
    kernels and through the plain path (micro 2 x gas 2, S 1024): the
    same overflow flags and scales, losses within FP16_PARITY_RTOL."""
    conf = json.loads(json.dumps(FP16_TRAIN_CONFIG))
    conf.update(train_batch_size=4, train_micro_batch_size_per_gpu=2,
                gradient_accumulation_steps=2)
    conf["fp16"]["initial_scale_power"] = 20
    conf["scheduler"]["params"]["warmup_min_lr"] = 6e-5
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(2, 2, TRAIN_SEQ))).cuda()
    runs = {}
    for use_kernels in (True, False):
        model = build_model(torch.float32, seed=1,
                            num_layers=FP16_PARITY_LAYERS)
        model.use_kernels = use_kernels
        eng, _ = fp16_engine(conf, model)
        runs[use_kernels] = fp16_steps(eng, (tokens, tokens),
                                       FP16_PARITY_STEPS)
        del eng, model
        torch.cuda.empty_cache()
    (lk, ok_, sk, _), (lp, op, sp, _) = runs[True], runs[False]
    rel = np.abs(np.array(lk) - np.array(lp)) / np.abs(np.array(lp))
    res = {"kernels": lk, "plain": lp, "overflows_kernels": ok_,
           "overflows_plain": op, "scales_kernels": sk, "scales_plain": sp,
           "max_rel_diff": float(rel.max()), "rtol": FP16_PARITY_RTOL}
    report["train_fp16_parity"] = res
    print(f"  losses kernels {[round(x, 5) for x in lk]} vs plain "
          f"{[round(x, 5) for x in lp]}: max relative difference "
          f"{rel.max():.3e}; overflows {ok_} (plain {op})", flush=True)
    if ok_ != op or sk != sp or not any(ok_) or all(ok_):
        fail(f"fp16 parity: the overflow flags or scales differ between the "
             f"kernel path and the plain path (or no step overflowed or "
             f"every one did): {res}")
    if not (np.isfinite(lk).all() and (rel <= FP16_PARITY_RTOL).all()):
        fail(f"fp16 parity: losses differ beyond rtol {FP16_PARITY_RTOL}: "
             f"{res}")
    return res


def serve_fp16(fa, da, report):
    """Phase 32, serve-fp16-125M: phase 4's stream with fp16 weights and
    fp16 pools through `InferenceEngine` (every prefill launch on the
    tensor cores, every decode launch on the cluster kernel), then greedy
    tokens of 8 prompts x 16 new through the kernels and through the
    plain path: every first token identical (the prefill logits agree;
    later tokens can part at a near tie, and the count is reported)."""
    from deeperspeed_tpu_torch import InferenceEngine
    sv = serve(fa, da, report, model=build_model(torch.float16),
               key="serve_fp16")
    if sv["dtypes"] != {"weight": "torch.float16", "compute": "torch.float16",
                        "kv_cache": "torch.float16"}:
        fail(f"serve-fp16-125M did not serve fp16 weights and pools: "
             f"{sv['dtypes']}")
    model = build_model(torch.float16, seed=1)
    cfg = model.config
    rng = np.random.default_rng(1)
    lens = [9, 64, 65, 130, 200, 300, 513, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    fast = InferenceEngine(model, config=SERVE_CONFIG).generate(
        prompts, max_new_tokens=16)
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(SERVE_CONFIG))
    plain_cfg["inference"]["kernel"] = "xla"
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    same = [a == b for a, b in zip(fast, plain)]
    first = [a[0] == b[0] for a, b in zip(fast, plain)]
    sv["parity"] = {"prompt_lengths": lens, "identical": same,
                    "first_token_identical": first}
    print(f"  fp16 greedy parity: {sum(same)}/{len(same)} requests "
          f"token-identical, {sum(first)}/{len(first)} first tokens",
          flush=True)
    if not all(first):
        fail(f"fp16 greedy first tokens differ between the kernel path and "
             f"the plain path: {fast} vs {plain}")
    del model
    torch.cuda.empty_cache()
    return sv


# phase 33, train-sparse-125M-16k-fp16: phase 13's rung with GPT-NeoX
# configs/125M.yml's fp16 block, from 2^16 as phase 31's short rungs
SPARSE_FP16_CONFIG = {**SPARSE_TRAIN_CONFIG, "fp16": FP16_SHORT}
# phase 34, serve-quant-125M-fp16: row_quant's int8 rungs in fp16
QUANT_FP16_RUNGS = (("int8w_fp16", "int8", None),
                    ("int8w_int8kv_fp16", "int8", "int8"))
# phase 35: a client head, TiledLinear(768, 50304) at GPT-NeoX-125M's head
# width in 2 x 8 tiles, on micro 8 x 1024 features; 5 steps a run
TILED_IN, TILED_OUT, TILED_SPLITS = 768, 50304, (2, 8)
TILED_MICRO, TILED_STEPS = 8, 5
TILED_CONFIG = {"train_batch_size": TILED_MICRO,
                "train_micro_batch_size_per_gpu": TILED_MICRO,
                "gradient_accumulation_steps": 1, "steps_per_print": 10_000,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 2}}
# tiled against dense losses: the tiles' two bf16 (fp16) partial
# products, each rounded before the fp32 sum, against one product
TILED_LOSS_RTOL = 1e-2
# the client optimizer of phase 35: SGD with momentum (lr, momentum)
CLIENT_SGD = (0.5, 0.9)


def train_sparse_fp16(fa, bsa, ad, report, remat=False):
    """Phase 33, train-sparse-125M-16k-fp16: phase 13's model, batch and
    JSON with the fp16 block from 2^16, 10 steps with (``remat``) and
    without the bench row's "full" remat: 12 (24 with remat) block-sparse
    forward, 12 dk/dv and 12 dq launches a step, every one "mma", no
    flash launch, one Adam a taken step; the loss scale equal to the JAX
    rule's replay over the observed overflows; the loss falling."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    model = GPTNeoX(GPTNeoXConfig(**SPARSE_MODEL), device="cuda")
    model.init_params(5)
    conf = dict(SPARSE_FP16_CONFIG)
    if remat:
        conf["activation_checkpointing"] = {"policy": "full"}
    eng, *_ = dst.initialize(model=model, config_params=conf)
    cfg = model.config
    arm = model.sparse_self_attention.arm(SPARSE_SEQ, cfg.head_dim)
    if eng.compute_dtype != torch.float16 or arm != "block_sparse":
        fail(f"train-sparse-125M-16k-fp16: compute {eng.compute_dtype}, arm "
             f"{arm}")
    micro = eng.train_micro_batch_size_per_gpu()
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, micro, SPARSE_SEQ))).cuda()
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts(fa, bsa)
    ad.reset_launches()
    losses, overflows, scales, step_s = fp16_steps(
        eng, (tokens, tokens), SPARSE_STEPS)
    taken = overflows.count(False)
    launches = dict(attention_counts(fa, bsa), adam=ad.launches)
    want = {k: 0 for k in launches}
    want.update(block_sparse_fwd=(2 if remat else 1) * L * SPARSE_STEPS,
                block_sparse_dkv=L * SPARSE_STEPS,
                block_sparse_dq=L * SPARSE_STEPS, adam=taken)
    if launches != want:
        fail(f"train-sparse-125M-16k-fp16 launch counts {launches} != {want}"
             f" ({L} layers x {SPARSE_STEPS} steps, {taken} taken; remat "
             f"{remat})")
    design = check_sparse_design(bsa, "train-sparse-125M-16k-fp16",
                                 launches, "mma")
    replay = check_scale_replay("train-sparse-125M-16k-fp16", conf,
                                overflows, scales)
    taken_losses = [l for l, o in zip(losses, overflows) if not o]
    if not (taken >= 2 and all(np.isfinite(taken_losses)) and
            taken_losses[-1] < taken_losses[0]):
        fail(f"train-sparse-125M-16k-fp16: {taken} steps taken, losses "
             f"{taken_losses} (want the loss to fall)")
    med = float(np.median([t for t, o in zip(step_s, overflows) if not o]))
    res = {"steps": SPARSE_STEPS, "taken": taken, "overflows": overflows,
           "loss_scale": scales, "loss_scale_replay": replay,
           "losses": losses, "taken_losses": taken_losses,
           "step_ms_median": med * 1e3, "step_ms": [t * 1e3 for t in step_s],
           "tokens_per_s": micro * SPARSE_SEQ / med,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "design_launches": design,
           "adam_variants": dict(ad.variant_launches),
           "activation_checkpointing": "full" if remat else False}
    print(f"  {SPARSE_STEPS} steps, {taken} taken; loss scale "
          f"{scales[0]:g} -> {scales[-1]:g} (the JAX rule's replay); taken "
          f"losses {taken_losses[0]:.4f} -> {taken_losses[-1]:.4f}; median "
          f"taken step {med * 1e3:.1f} ms, {res['tokens_per_s']:.0f} tokens/"
          f"s, peak memory {res['max_memory_allocated_gb']:.2f} GiB; remat "
          f"{remat}", flush=True)
    report["train_sparse_fp16_remat" if remat else "train_sparse_fp16"] = res
    del eng, model
    torch.cuda.empty_cache()
    return res


def serve_quant_fp16(fa, da, qm, report):
    """Phase 34, serve-quant-125M-fp16: row_quant's stream (16 x 62 prompt
    x 48 new) with fp16 weights at the int8w and int8w_int8kv rungs, exact
    launches, every int8 matmul "wgmma", every int8 decode "cluster"; then
    greedy tokens of 8 prompts x 16 new with int8 weights and pages
    through the kernels and through the plain path: every first token
    identical."""
    from deeperspeed_tpu_torch import InferenceEngine
    model = build_model(torch.float16)
    cfg = model.config
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=QUANT_PROMPT))
               for _ in range(QUANT_REQUESTS)]
    rungs = {}
    for tag, weights, kv_dtype in QUANT_FP16_RUNGS:
        r = serve_quant_rung(model, prompts, tag, weights, kv_dtype, fa, da,
                             qm)
        if r["dtypes"]["compute"] != "torch.float16":
            fail(f"{tag} did not serve in fp16: {r['dtypes']}")
        rungs[tag] = r
        print(f"  {tag}: decode {r['decode_tok_s']:.1f} tokens/s, stream "
              f"{r['stream_tok_s']:.1f} tokens/s, inter-token p50 "
              f"{r['inter_token_p50_ms']:.2f} ms, launches {r['launches']}, "
              f"dtypes {r['dtypes']}", flush=True)
    del model
    model = build_model(torch.float16, seed=1)
    lens = [9, 64, 65, 130, 200, 300, 513, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    conf = _quant_config(SERVE_CONFIG, "int8", "int8")
    qm.launches = da.launches_int8 = 0
    fast = InferenceEngine(model, config=conf).generate(
        prompts, max_new_tokens=16)
    launched = {"quant_matmul": qm.launches,
                "paged_decode_int8": da.launches_int8}
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(conf))
    plain_cfg["inference"]["kernel"] = "xla"
    qm.launches = da.launches_int8 = 0
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    same = [a == b for a, b in zip(fast, plain)]
    first = [a[0] == b[0] for a, b in zip(fast, plain)]
    print(f"  fp16 int8 greedy parity: {sum(same)}/{len(same)} requests "
          f"token-identical, {sum(first)}/{len(first)} first tokens; kernel "
          f"launches {launched}", flush=True)
    if qm.launches or da.launches_int8 or not all(launched.values()):
        fail(f"fp16 int8 parity: the kernel path launched {launched}, the "
             f"plain path {qm.launches} / {da.launches_int8}")
    if not all(first):
        fail(f"fp16 int8 greedy first tokens differ between the kernel path "
             f"and the plain path: {fast} vs {plain}")
    res = {"rungs": rungs, "parity": {"prompt_lengths": lens,
                                      "identical": same,
                                      "first_token_identical": first,
                                      "kernel_launches": launched}}
    report["serve_quant_fp16"] = res
    del model
    torch.cuda.empty_cache()
    return res


def tiled_models():
    """(TiledHead, DenseHead): client modules for `initialize()`, a
    TiledLinear head (or the dense nn.Linear holding the same weights)
    over given features, mean cross-entropy against labels."""
    from deeperspeed_tpu_torch.runtime.zero import TiledLinear

    class Head(torch.nn.Module):
        def params_tree(self):
            return dict(self.named_parameters())

        def loss_fn(self, params, batch, rng=None):
            x, y = batch
            dtype = next(self.parameters()).dtype
            logits = self.head(x.to(dtype)).float()
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), y.reshape(-1))

    class TiledHead(Head):
        def __init__(self):
            super().__init__()
            self.head = TiledLinear(TILED_IN, TILED_OUT,
                                    in_splits=TILED_SPLITS[0],
                                    out_splits=TILED_SPLITS[1],
                                    device="cuda")
            self.head.init_params(torch.Generator().manual_seed(0))

    class DenseHead(Head):
        def __init__(self, tiled):
            super().__init__()
            self.head = torch.nn.Linear(TILED_IN, TILED_OUT, device="cuda")
            with torch.no_grad():
                self.head.weight.copy_(tiled.head.to_dense().t())
                self.head.bias.copy_(tiled.head.bias)
    return TiledHead, DenseHead


class ClientSGD:
    """SGD with momentum through the client-optimizer protocol (the rule
    `tests/test_torch_tiling.py` also runs on the JAX engine): ``update``
    returns (new masters, state)."""

    def __init__(self, lr, momentum):
        self.param_groups = [{"lr": lr, "momentum": momentum}]

    def init_state(self, master):
        return (0, torch.zeros_like(master, dtype=torch.float32))

    def update(self, grads, state, master, lr=None):
        step, buf = state
        buf = self.param_groups[0]["momentum"] * buf + grads.float()
        return master - lr * buf, (step + 1, buf)


def tiled_run(model, conf, batch, ad, what):
    import deeperspeed_tpu_torch as dst
    eng, *_ = dst.initialize(model=model, config_params=conf)
    ad.reset_launches()
    losses, overflows, scales, step_s = fp16_steps(eng, batch, TILED_STEPS)
    taken = overflows.count(False)
    if ad.launches != taken or not all(np.isfinite(losses)):
        fail(f"{what}: {ad.launches} Adam launches for {taken} taken steps, "
             f"losses {losses}")
    res = {"losses": losses, "overflows": overflows, "loss_scale": scales,
           "taken": taken, "adam_launches": ad.launches,
           "adam_variants": dict(ad.variant_launches),
           "step_ms_median": float(np.median(step_s)) * 1e3}
    return eng, res


def train_tiled(ad, report):
    """Phase 35: a client module whose head is TiledLinear(768, 50304) in
    2 x 8 tiles, trained through `initialize()` → `train_batch` for 5
    steps in bf16 and in fp16 (from 2^16) beside the dense nn.Linear
    holding the same weights (losses within TILED_LOSS_RTOL, the first
    step's within a tenth of it, one Adam a taken step); then the tiled
    bf16 run's first step once more through a client SGD with momentum:
    no Adam launch, the first step's loss bit-equal to the Adam run's,
    the masters equal to the rule's p - lr·g from the gradient the engine
    handed it, the momentum its g, the bf16 compute copy the masters
    rounded."""
    import deeperspeed_tpu_torch as dst
    TiledHead, DenseHead = tiled_models()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1, TILED_MICRO, TRAIN_SEQ, TILED_IN, generator=gen,
                    device="cuda")
    y = torch.randint(0, TILED_OUT, (1, TILED_MICRO, TRAIN_SEQ),
                      generator=gen, device="cuda")
    res = {"splits": TILED_SPLITS, "shape": f"{TILED_IN} x {TILED_OUT}",
           "tokens_a_step": TILED_MICRO * TRAIN_SEQ}
    for tag, block in (("bf16", {"enabled": True, "type": "bfloat16"}),
                       ("fp16", FP16_SHORT)):
        conf = {**TILED_CONFIG, "fp16": block}
        tiled = TiledHead()
        dense = DenseHead(tiled)
        _, rt = tiled_run(tiled, conf, (x, y), ad, f"tiled {tag}")
        _, rd = tiled_run(dense, conf, (x, y), ad, f"dense {tag}")
        lt, ld = np.array(rt["losses"]), np.array(rd["losses"])
        rel = np.abs(lt - ld) / np.abs(ld)
        row = {"tiled": rt, "dense": rd, "loss_rel_diff": rel.tolist(),
               "tol": TILED_LOSS_RTOL}
        print(f"  {tag}: tiled losses {lt.round(4).tolist()}, dense "
              f"{ld.round(4).tolist()}, relative difference max "
              f"{rel.max():.2e}; step {rt['step_ms_median']:.1f} ms tiled, "
              f"{rd['step_ms_median']:.1f} ms dense; Adam launches "
              f"{rt['adam_launches']} / {rd['adam_launches']}", flush=True)
        if rt["overflows"] != rd["overflows"] or \
                rel.max() > TILED_LOSS_RTOL or rel[0] > TILED_LOSS_RTOL / 10:
            fail(f"phase 35 {tag}: the tiled head does not train like the "
                 f"dense one: {row}")
        res[tag] = row
        del tiled, dense
        torch.cuda.empty_cache()
    # the client optimizer: one bf16 step of the tiled head
    conf = {k: v for k, v in TILED_CONFIG.items() if k != "optimizer"}
    conf["fp16"] = {"enabled": True, "type": "bfloat16"}
    opt = ClientSGD(*CLIENT_SGD)
    seen = {}
    inner = opt.update

    def update(grads, state, master, lr=None):
        seen.update(grads=grads.clone(), master=master.clone(), lr=lr)
        return inner(grads, state, master, lr=lr)
    opt.update = update
    eng, *_ = dst.initialize(model=TiledHead(), optimizer=opt,
                             config_params=conf)
    ad.reset_launches()
    loss = eng.train_batch(batch=(x, y))
    torch.cuda.synchronize()
    lr, mu = CLIENT_SGD
    want = seen["master"] - seen["lr"] * (mu * 0.0 + seen["grads"].float())
    client = {"loss": loss, "loss_adam_run": res["bf16"]["tiled"]["losses"][0],
              "adam_launches": ad.launches, "lr": seen["lr"],
              "masters_follow_the_rule": bool(torch.equal(eng._master,
                                                          want)),
              "momentum_is_g": bool(torch.equal(eng.opt_state[1],
                                                seen["grads"].float())),
              "compute_copy_is_masters": bool(torch.equal(
                  eng._params_flat, eng._master.to(torch.bfloat16))),
              "step": eng.opt_state[0]}
    print(f"  client SGD (momentum {mu}, lr {lr}): {client}", flush=True)
    if not (client["masters_follow_the_rule"] and client["momentum_is_g"] and
            client["compute_copy_is_masters"] and client["step"] == 1 and
            client["adam_launches"] == 0 and
            abs(loss - client["loss_adam_run"]) <=
            1e-6 * abs(client["loss_adam_run"])):
        fail(f"phase 35: the client optimizer's step does not follow its "
             f"rule: {client}")
    res["client_sgd"] = client
    report["train_tiled"] = res
    del eng
    torch.cuda.empty_cache()
    return res


def run_fp16_phases(fa, da, gm, ad, bsa, qm, report, card, bf16=None,
                    profile_step=False):
    """Phases 31-35 → (31(a), 31(b), 31(c), 31(e), 32, 33, 33 with remat,
    34, 35) results."""
    from deeperspeed_tpu_torch import BertConfig, BertForPreTraining
    print(f"fp16 training train-fp16-125M (GPT-NeoX configs/125M.yml's fp16 "
          f"block from 2^32, fp32 masters, ZeRO-2) on {card}:", flush=True)
    ta = train_fp16(fa, ad, report, bf16, profile_step)
    print("fp16 MoE training train-moe-125M (8 experts, top-2, sort; fp16 "
          "from 2^16):", flush=True)
    tb = train_fp16_short(fa, ad, report, "train_moe_fp16",
                          {**MOE_TRAIN_CONFIG, "fp16": FP16_SHORT},
                          FP16_MOE_STEPS, gm=gm)
    print("fp16 BERT training train-bert-large-512-fp16-lamb (Lamb, fp16 "
          "from 2^16, ZeRO-2, dropout 0.1):", flush=True)
    cfg = BertConfig.large()
    tc = train_fp16_short(
        fa, ad, report, "train_bert_fp16_lamb", FP16_BERT_CONFIG,
        FP16_BERT_STEPS,
        model=BertForPreTraining(cfg, device="cuda").init_params(1),
        bert=True)
    print("fp16 lean state train-fp16-125M-lean (fp16 masters and moments, "
          "ZeRO 0, fp16 from 2^16):", flush=True)
    te = train_fp16_short(fa, ad, report, "train_fp16_lean",
                          FP16_LEAN_CONFIG, FP16_LEAN_STEPS, lean=True)
    print("fp16 legacy loop (phase 7's model, fp16 from 2^16):",
          flush=True)
    train_fp16_legacy(fa, ad, report)
    print("fp16 training parity (4 layers, kernels vs plain, fp16 from "
          "2^20):", flush=True)
    train_fp16_parity(report)
    print(f"serving serve-fp16-125M (fp16 weights and pools) on {card}:",
          flush=True)
    sv = serve_fp16(fa, da, report)
    print(f"  {sv['generated_tokens']} tokens in {sv['wall_s']:.3f} s: "
          f"{sv['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{sv['ttft_p50_ms']:.2f} ms, inter-token p50 "
          f"{sv['inter_token_p50_ms']:.2f} ms / p99 "
          f"{sv['inter_token_p99_ms']:.2f} ms, launches {sv['launches']}, "
          f"decode by design {sv['decode_design_launches']}", flush=True)
    print(f"fp16 sparse training train-sparse-125M-16k-fp16 (fixed l16g1, "
          f"fp16 from 2^16, ZeRO-2) on {card}:", flush=True)
    ts = train_sparse_fp16(fa, bsa, ad, report)
    print("train-sparse-125M-16k-fp16 with the bench row's remat "
          "(\"full\"):", flush=True)
    tsr = train_sparse_fp16(fa, bsa, ad, report, remat=True)
    print(f"fp16 int8 serving serve-quant-125M-fp16 (int8 weights / int8 "
          f"weights + int8 KV) on {card}:", flush=True)
    sq = serve_quant_fp16(fa, da, qm, report)
    print(f"TiledLinear(768, 50304) head in 2 x 8 tiles (bf16, fp16, a "
          f"client SGD) on {card}:", flush=True)
    tt = train_tiled(ad, report)
    return ta, tb, tc, te, sv, ts, tsr, sq, tt


def fp16_kernel_rows(k3, ta, tb, tc, te, sv, ts, tsr, sq, tt):
    """The fp16 variants' entries of the kernels line: each with its
    launches on phases 31-35 (the main path) and phase 3's numbers."""
    pallas = "deeperspeed_tpu/ops/pallas/"
    ft, fbert = k3["flash_train"], k3["flash_bert"]
    dec = k3["decode_timed"][0]
    g0 = k3["grouped_matmul"][0]
    train_fwd = ta["launches"]["flash_fwd"] + tb["launches"]["flash"]["fwd"] \
        + te["launches"]["flash"]["fwd"]
    shape = "B=16 S=1024 H=12 D=64 fp16, causal"
    rows = [
        {"name": "flash_fwd_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{pallas}flash_attention.py:497 (_fwd_kernel); :360, "
                     f":378 (_fwd_single*); flags :209, :1374, :1421",
         "launches": train_fwd + tc["launches"]["flash"]["fwd"] +
         sv["launches"]["flash_fwd"],
         "launches_by_path": {"train_fp16": ta["launches"]["flash_fwd"],
                              "train_moe_fp16": tb["launches"]["flash"][
                                  "fwd"],
                              "train_bert_fp16_lamb": tc["launches"][
                                  "flash"]["fwd"],
                              "train_fp16_lean": te["launches"]["flash"][
                                  "fwd"],
                              "serve_fp16": sv["launches"]["flash_fwd"]},
         "design": "fp16 at D 64/128: the tensor-core kernel "
                   "(mma.sync f32.f16.f16.f32)",
         "max_abs_err": max(ft["max_abs_err_out"], ft["max_abs_err_lse"]),
         "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"], "shape": shape,
         "tolerance": TOL_FP16["out"],
         "kbias_dropout_shape": {k: fbert[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bwd_ms", "plain_bwd_ms", "library_bwd_ms", "bwd_bound_ms",
             "max_abs_err_out")},
         "segments_shape": {k: k3["flash_segments"][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} | {
             "shape": "B=4 S=1024 H=12 D=64 fp16, ragged segments"}},
        {"name": "flash_bwd_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{pallas}flash_attention.py:736, :763 "
                     f"(_bwd_single*); :948, :1038 (_bwd_dkv_kernel, "
                     f"_bwd_dq_kernel)",
         "launches": ta["launches"]["flash_bwd_dkv"] +
         tb["launches"]["flash"]["dkv"] + tc["launches"]["flash"]["dkv"] +
         te["launches"]["flash"]["dkv"],
         "design": "fp16 at D 64/128: the tensor-core kernels, dS rounded "
                   "to fp16 (inf past 65504) before dQ and dK",
         "max_abs_err": max(ft[f"max_abs_err_{g}"] for g in ("dq", "dk",
                                                              "dv")),
         "ms": ft["bwd_ms"], "plain_ms": ft["plain_bwd_ms"],
         "bound_ms": ft["bwd_bound_ms"], "bound_by": ft["bwd_bound_by"],
         "library_ms": ft["library_bwd_ms"],
         "shape": shape + " (dkv + dq kernels)",
         "tolerance": TOL_FP16["bwd"],
         "segments_shape": {k: k3["flash_segments"][k] for k in (
             "bwd_ms", "plain_bwd_ms", "library_bwd_ms", "bwd_bound_ms",
             "bwd_bound_by")} | {
             "shape": "B=4 S=1024 H=12 D=64 fp16, ragged segments"},
         "overflow_case": k3["flash_overflow"]},
        {"name": "paged_decode_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:84 (_decode_kernel)",
         "launches": sv["launches"]["paged_decode"],
         "design_launches": sv["decode_design_launches"],
         "max_abs_err": dec["max_abs_err"], "ms": dec["ms"],
         "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
         "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
         "library": dec["library"],
         "shape": f"{dec['shape']} fp16, lengths {dec['lengths_drawn']}",
         "tolerance": TOL_FP16["decode"], **decode_graph_times(dec),
         "serving_shape": decode_shape_row(k3["decode_timed"][1])},
        {"name": "grouped_matmul_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:121 (_fwd_kernel; also dx)",
         "launches": tb["launches"]["grouped_matmul"],
         "design_launches": tb["design_launches"]["grouped_matmul"],
         "max_abs_err": g0["max_abs_err"], "ms": g0["ms"],
         "graph_ms": g0["graph_ms"], "plain_ms": g0["plain_ms"],
         "bound_ms": g0["bound_ms"], "bound_by": g0["bound_by"],
         "library_ms": g0["library_ms"], "shape": gmm_shape(g0),
         "tolerance": f"{TOL_FP16['gmm']} x max|ref|",
         "dx": [{k: r[k] for k in ("K", "N", "dx_ms", "dx_library_ms",
                                   "dx_bound_ms", "max_abs_err_dx")}
                for r in k3["grouped_matmul"]]},
        {"name": "grouped_matmul_dw_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:174 (_dw_kernel)",
         "launches": tb["launches"]["grouped_matmul_dw"],
         "design_launches": tb["design_launches"]["grouped_matmul_dw"],
         "max_abs_err": g0["max_abs_err_dw"], "ms": g0["dw_ms"],
         "graph_ms": g0["dw_graph_ms"], "plain_ms": g0["dw_plain_ms"],
         "bound_ms": g0["dw_bound_ms"], "bound_by": g0["dw_bound_by"],
         "library_ms": g0["dw_library_ms"],
         "shape": gmm_shape(g0) + ", fp32 dW",
         "tolerance": f"{TOL_GMM_DW} x max|ref|"},
    ]
    for tag, runs in (("classic", (ta, tb)), ("lean", (te,))):
        a = k3["adam"][tag]
        rows.append(
            {"name": f"adam_fp16_{tag}", "route": "cuda",
             "source": "deeperspeed_tpu_torch/csrc/adam.cu",
             "replaces": f"{pallas}optimizer.py:34 (_adam_kernel)",
             "launches": sum(r["adam_variants"].get(f"fp16 {tag}", 0)
                             for r in runs),
             "max_abs_err": a["max_abs_err_p"], "ms": a["ms"],
             "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
             "bound_by": a["bound_by"], "library_ms": a["library_ms"],
             "library": a["library"],
             "shape": f"n={a['n']} {a['storage']}",
             "tolerance": "bit-equal" if tag == "lean" else TOL_ADAM})
    # phase 35's fp16 runs step the tiled and the dense head with it too
    head = {m: tt["fp16"][m]["adam_launches"] for m in ("tiled", "dense")}
    rows[-2]["launches"] += sum(head.values())
    rows[-2]["launches_train_tiled_fp16"] = head
    bs = k3["block_sparse"]
    shape16 = "B=2 S=16384 H=12 D=64 fp16, fixed l16g1 causal"
    for part, line, what in (
            ("fwd", 140, "_sparse_fwd_kernel, via sparse_attention_fwd "
                         ":213"),
            ("dkv", 281, "_sparse_dkv_kernel, via sparse_attention_bwd "
                         ":393"),
            ("dq", 343, "_sparse_dq_kernel, via sparse_attention_bwd "
                        ":393")):
        key = f"block_sparse_{part}"
        err = {"fwd": max(bs["max_abs_err_out"], bs["max_abs_err_lse"]),
               "dkv": max(bs["max_abs_err_dk"], bs["max_abs_err_dv"]),
               "dq": bs["max_abs_err_dq"]}[part]
        rows.append(
            {"name": f"{key}_fp16", "route": "cuda",
             "source": "deeperspeed_tpu_torch/csrc/block_sparse_attention.cu",
             "replaces": f"{pallas}block_sparse_attention.py:{line} ({what})",
             "launches": ts["launches"][key] + tsr["launches"][key],
             "launches_by_path": {"train_sparse_fp16": ts["launches"][key],
                                  "train_sparse_fp16_remat": tsr[
                                      "launches"][key]},
             "design": "fp16 at D 64/128: the mma.sync tile steps "
                       "(f32.f16.f16.f32), P and dS rounded to nearest "
                       "fp16",
             "design_launches": {
                 "train_sparse_fp16": ts["design_launches"][part],
                 "train_sparse_fp16_remat": tsr["design_launches"][part]},
             "max_abs_err": err, "ms": bs[f"{part}_ms"],
             "plain_ms": bs["plain_fwd_ms" if part == "fwd" else
                            "plain_bwd_ms"],
             "bound_ms": bs[f"{part}_bound_ms"],
             "bound_by": bs[f"{part}_bound_by"],
             "library_ms": bs["library_fwd_ms" if part == "fwd" else
                              "library_bwd_ms"],
             "library": f"SDPA in fp16 under the bool token mask"
                        f"{'' if part == 'fwd' else ' (backward: dq, dk, dv)'}"
                        f", B={bs['library_batch']}",
             "shape": shape16,
             "tolerance": bs["tol_out"] if part == "fwd" else bs["tol_bwd"],
             "d128": bs["d128"], "overflow_case": bs["overflow"]})
    qk = k3["quant_matmul"]
    q0 = next(r for r in qk["rows"] if "ms" in r)
    rows.append(
        {"name": "quant_matmul_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/quant_matmul.cu",
         "replaces": f"{pallas}quant_matmul.py:152 (_wq_kernel)",
         "launches": sum(r["launches"]["quant_matmul"]
                         for r in sq["rungs"].values()),
         "launches_by_rung": {t: r["launches"]["quant_matmul"]
                              for t, r in sq["rungs"].items()},
         "design": "fp16: qmm_wgmma_kernel<__half, TN>, wgmma "
                   "f32.f16.f16, the int8 tile widened to fp16 in shared "
                   "memory (exact), fp16 TMA maps",
         "design_launches_by_rung": {
             t: r["quant_matmul_design_launches"]
             for t, r in sq["rungs"].items()},
         "max_abs_err": q0["max_abs_err"], "ms": q0["ms"],
         "plain_ms": q0["plain_ms"], "bound_ms": q0["bound_ms"],
         "bound_by": q0["bound_by"], "library_ms": q0["library_ms"],
         "library": "torch.matmul on the dequantized fp16 weight",
         "shape": f"M={q0['M']} K={q0['K']} N={q0['N']} fp16",
         "tolerance": f"{TOL_QMM[torch.float16]} x max|ref|",
         **graph_times(q0), "overflow_case": qk["overflow"],
         "other_shapes": [{k: r[k] for k in (
             "M", "K", "N", "plan", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by", "max_abs_err")} | graph_times(r)
             for r in qk["rows"] if "ms" in r and r is not q0]})
    di, di_serve = k3["decode_int8_timed"]
    rung = sq["rungs"]["int8w_int8kv_fp16"]
    rows.append(
        {"name": "paged_decode_int8_fp16", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:152 "
                     f"(_decode_kernel_quant)",
         "launches": rung["launches"]["paged_decode_int8"],
         "design": "fp16 q over int8 pools with bf16 scales: the cluster "
                   "kernel (split-KV, rank-order merge), P in fp32",
         "design_launches": rung["decode_design_launches"][
             "paged_decode_int8"],
         "max_abs_err": di["max_abs_err"], "ms": di["ms"],
         "plain_ms": di["plain_ms"], "bound_ms": di["bound_ms"],
         "bound_by": di["bound_by"], "library_ms": di["library_ms"],
         "library": di["library"],
         "shape": f"{di['shape']} int8 pools, bf16 scales, fp16 q, "
                  f"lengths {di['lengths_drawn']}",
         "tolerance": di["tol"], **decode_graph_times(di),
         "serving_shape": decode_shape_row(di_serve)})
    return rows


def fp16_only(card, profile_step=False):
    """Phase 3's fp16 cases and phases 31-35 alone, with phase 7 (bf16)
    first for the step, tokens/s and MFU beside phase 31(a)'s (and, with
    ``profile_step``, both steps profiled)."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("fp16 kernels vs plain versions:", flush=True)
    k3 = check_fp16_kernels(fa, da, gm, ad, bsa, qm, gen, report,
                            GPTNeoXConfig(**NEOX_125M).num_params())
    print("training GPT-NeoX-125M (bf16, phase 7):", flush=True)
    tr = train(fa, ad, report, profile_step=profile_step)
    if profile_step:
        print_profile("bf16 training step (gas 2 x micro 16 x 1024)",
                      tr["profile"], card)
    phases = run_fp16_phases(fa, da, gm, ad, bsa, qm, report, card,
                             bf16=tr, profile_step=profile_step)
    report["kernels"] = fp16_kernel_rows(k3, *phases)
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_fp16.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases 36-38: quantized training (the "quantization.ffn" block) and
# GPT-2 XL served with int8 weights
# ---------------------------------------------------------------------------

# phase 36 (train-fp8ffn-125M): phase 7's rung with the delayed-scaling
# fp8 FFN (amax history 16), its own rung: bench.py row_quant has no FFN
# part; then an int8-recipe rung of 6 steps
QUANT_HISTORY = 16


def quant_conf(base, recipe):
    """``base`` with quantization.ffn (``recipe``, amax history 16)."""
    conf = json.loads(json.dumps(base))
    conf["quantization"] = {"ffn": {"recipe": recipe,
                                    "amax_history_len": QUANT_HISTORY}}
    return conf


QUANT_INT8_STEPS = 6
# 36(b): the kernels against the plain path at 125M widths, 4 layers, 4
# fp32 steps a recipe. Losses within rtol 1e-4 (phase 8's); histories
# within rtol 2e-2: the two paths sum attention in other orders, and an
# fp32 ulp can move one element across an fp8 / int8 rounding boundary
# (a step of up to 2^-3 of its value), whose layer the next layer's
# input amax follows (the CPU tests' bound against the JAX engine, for
# the same reason)
QUANT_PARITY_LAYERS, QUANT_PARITY_STEPS = 4, 4
QUANT_PARITY_RTOL = {"loss": 1e-4, "amax": 2e-2}
# 36(c): fp16 from 2^32 (configs/125M.yml's block) and a save / resume,
# both at 4 layers
QUANT_RESUME_STEPS = 3
# phase 37 (train-moe-125M-int8ffn): phase 11's rung with the int8 FFN;
# its loss is held over the last 3 steps (phase 11's own run spiked once,
# at its step 10: 13.88 between 7.05 and 6.32)
QUANT_MOE_STEPS = 10
# phase 38 (serve-gpt2xl-int8): GPT-2 XL's four block weights (qkv,
# out-proj, mlp-in, mlp-out), at a decode step of 16 rows and a prefill
# call of 4 x 64; N = 4800 and 1600 leave a partial 128-column tile
GPT2_XL_QMM_SHAPES = ((1600, 4800), (1600, 1600), (1600, 6400), (6400, 1600))
GPT2_XL_QMM_ROWS = (16, 256)
QUANT_XL_RUNGS = (("bf16", None, None), ("int8w", "int8", None))
QUANT_XL_PARITY_LAYERS = 2


def check_quant_history(key, eng, ffn, first, gas, steps):
    """The amax history of a quantized run: [L, 4, 16] fp32, finite; after
    the first step the first ``gas`` slots written (> 0) and the rest
    zero; at the end every slot written and moved since the first step."""
    L = eng.module.config.num_layers
    amax = eng.quant.amax
    want = (L, 4, ffn["amax_history_len"])
    filled = min(gas * steps, want[2])
    ok = (tuple(amax.shape) == want and amax.dtype == torch.float32 and
          bool(torch.isfinite(amax).all()) and
          bool((first[..., :gas] > 0).all()) and
          not bool(first[..., gas:].any()) and
          bool((amax[..., :filled] > 0).all()) and
          not bool(amax[..., filled:].any()) and
          not torch.equal(amax, first))
    res = {"shape": list(amax.shape), "dtype": str(amax.dtype),
           "finite": bool(torch.isfinite(amax).all()),
           "slots_written": filled, "max": float(amax.max()),
           "min_written": float(amax[..., :filled].min()),
           "layer0_slot0_after_step1": first[0, :, 0].tolist(),
           "layer0_slot0_last": amax[0, :, 0].tolist(),
           "advanced": not torch.equal(amax, first)}
    print(f"  {key} amax history {res}", flush=True)
    if not ok:
        fail(f"{key}: the amax history is not [L, 4, H] fp32, finite, "
             f"written one slot a micro-step and advanced: {res}")
    return res


def print_train(key, r, card, beside=None):
    line = (f"  {key}: {r['steps']} steps, loss {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}, median step {r['step_ms_median']:.1f} "
            f"ms, {r['tokens_per_s']:.0f} tokens/s")
    if r.get("mfu") is not None:
        line += f", MFU {r['mfu']:.4f}"
    if beside is not None:
        line += (f" (without the quantized FFN, same run: "
                 f"{beside['step_ms_median']:.1f} ms, "
                 f"{beside['tokens_per_s']:.0f} tokens/s" +
                 (f", MFU {beside['mfu']:.4f}" if beside.get("mfu")
                  is not None else "") + ")")
    print(line + f", peak memory {r['max_memory_allocated_gb']:.2f} GiB, "
          f"launches per step {r['launches_per_step']} on {card}",
          flush=True)


def fake_quant_on_card(report):
    """36(b), first: `_fake_quant` and `scale_from_history` on the card
    against the same functions on the host's CPU (which the CPU tests
    hold bit for bit to the JAX package's) over 2^20 values spread over
    16 binades either side of the range, at scales on and off a power of
    two and one taken from a history: bf16 and fp16 bit-equal, fp32
    bit-equal (the straight-through add rounds each operation alone on
    both), so the card's float8_e4m3fn cast and int8 rounding are the
    reference's."""
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    gen = torch.Generator(device="cuda").manual_seed(36)
    n = 1 << 20
    mag = torch.exp2(torch.randn(n, generator=gen, device="cuda") * 6)
    v = torch.randn(n, generator=gen, device="cuda") * mag
    hist = torch.tensor([0.0, 3.7, 1.25, 0.0], device="cuda")
    rows = []
    for recipe in ("fp8", "int8"):
        qmax = qm.recipe_qmax(recipe)
        s_hist = qm.scale_from_history(hist, torch.tensor(9.0, device="cuda"),
                                       qmax, 1.3)
        s_cpu = qm.scale_from_history(hist.cpu(), torch.tensor(9.0), qmax,
                                      1.3)
        if s_hist.item() != s_cpu.item():
            fail(f"scale_from_history on the card {s_hist.item()!r} != the "
                 f"CPU's {s_cpu.item()!r}")
        for dtype, bits in ((torch.bfloat16, torch.int16),
                            (torch.float16, torch.int16),
                            (torch.float32, torch.int32)):
            # fp16 holds no value past 65504 (an inf input is NaN after
            # the straight-through add, on any device)
            x = (v.clamp(-6e4, 6e4) if dtype == torch.float16 else v).to(
                dtype)
            mismatches, nonfinite = 0, 0
            for scale in (2.0 ** -7, 0.0123, 3.3, s_hist.item()):
                got = qm._fake_quant(x, torch.tensor(scale, device="cuda"),
                                     recipe).cpu()
                want = qm._fake_quant(x.cpu(), torch.tensor(scale), recipe)
                mismatches += int((got.view(bits) != want.view(bits)).sum())
                nonfinite += int((~torch.isfinite(got)).sum())
            rows.append({"recipe": recipe, "dtype": str(dtype), "values": n,
                         "scales": 4, "mismatches": mismatches,
                         "nonfinite": nonfinite})
    print(f"  fake-quant on the card vs the CPU: {rows}", flush=True)
    bad = [r for r in rows if r["mismatches"] or r["nonfinite"]]
    if bad:
        fail(f"_fake_quant on the card differs from the CPU's (or saturates "
             f"to a non-finite value): {bad}")
    report["quant_fake_quant_card"] = rows
    return rows


def quant_train_parity(fa, ad, report):
    """36(b): the fp8 and int8 FFN at 125M widths and 4 layers, fp32,
    micro 2 x gas 2 x 1024, 4 steps through the kernels and 4 through the
    plain path (no kernel launched there): losses within rtol 1e-4,
    histories within rtol 2e-2 (QUANT_PARITY_RTOL)."""
    import deeperspeed_tpu_torch as dst
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(2, 2, TRAIN_SEQ))).cuda()
    out = {}
    for recipe in ("fp8", "int8"):
        conf = quant_conf(TRAIN_CONFIG, recipe)
        conf.update(train_batch_size=4, train_micro_batch_size_per_gpu=2,
                    gradient_accumulation_steps=2, fp16={"enabled": False})
        conf["scheduler"]["params"]["warmup_min_lr"] = 6e-5
        runs = {}
        for use_kernels in (True, False):
            model = build_model(torch.float32, seed=1,
                                num_layers=QUANT_PARITY_LAYERS)
            model.use_kernels = use_kernels
            eng, *_ = dst.initialize(model=model, config_params=conf)
            fa.launches = ad.launches = 0
            losses = [eng.train_batch(batch=(tokens, tokens))
                      for _ in range(QUANT_PARITY_STEPS)]
            n = QUANT_PARITY_LAYERS * 2 * QUANT_PARITY_STEPS
            want = (n, QUANT_PARITY_STEPS) if use_kernels else (0, 0)
            if (fa.launches, ad.launches) != want:
                fail(f"36(b) {recipe}: flash / Adam launches "
                     f"{(fa.launches, ad.launches)} != {want} (use_kernels "
                     f"{use_kernels})")
            runs[use_kernels] = (np.array(losses),
                                 eng.quant.amax.cpu().numpy())
            del eng, model
            torch.cuda.empty_cache()
        (lk, ak), (lp, ap) = runs[True], runs[False]
        filled = min(2 * QUANT_PARITY_STEPS, QUANT_HISTORY)
        loss_rel = float((np.abs(lk - lp) / np.abs(lp)).max())
        amax_rel = float((np.abs(ak - ap) / np.maximum(np.abs(ap),
                                                       1e-30)).max())
        out[recipe] = {"losses_kernels": lk.tolist(),
                       "losses_plain": lp.tolist(),
                       "max_rel_diff_loss": loss_rel,
                       "max_rel_diff_amax": amax_rel,
                       "amax_written": bool((ak[..., :filled] > 0).all()),
                       "rtol": QUANT_PARITY_RTOL}
        print(f"  {recipe}: losses kernels {lk.tolist()} vs plain "
              f"{lp.tolist()}: max relative difference {loss_rel:.3e}; amax "
              f"histories {amax_rel:.3e}", flush=True)
        if not (np.isfinite(lk).all() and loss_rel <= QUANT_PARITY_RTOL[
                "loss"] and amax_rel <= QUANT_PARITY_RTOL["amax"] and
                out[recipe]["amax_written"]):
            fail(f"36(b) {recipe}: the kernel path and the plain path "
                 f"differ beyond {QUANT_PARITY_RTOL}: {out[recipe]}")
    report["train_quant_parity"] = out
    return out


def quant_fp16_overflow(fa, ad, report):
    """36(c), first: 125M widths at 4 layers in fp16 from 2^32
    (configs/125M.yml's block) with the fp8 FFN until 2 steps are taken:
    an overflow step launches no Adam and leaves the history as it was
    (the opening ones at its zeros); a taken step launches Adam once and
    writes its gas slots."""
    conf = quant_conf(FP16_TRAIN_CONFIG, "fp8")
    model = build_model(torch.float32, num_layers=QUANT_PARITY_LAYERS)
    eng, _ = fp16_engine(conf, model)
    gas = eng.gradient_accumulation_steps()
    micro = eng.train_micro_batch_size_per_gpu()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
    ad.reset_launches()
    overflows, adam, kept, zeros = [], [], [], []
    prev = eng.quant.amax.clone()
    while len(overflows) < FP16_MAX_STEPS and overflows.count(False) < 2:
        skipped, launched = eng.skipped_steps, ad.launches
        eng.train_batch(batch=(tokens, tokens))
        overflows.append(eng.skipped_steps > skipped)
        adam.append(ad.launches - launched)
        kept.append(torch.equal(eng.quant.amax, prev))
        zeros.append(not bool(eng.quant.amax.any()))
        prev = eng.quant.amax.clone()
    opening = overflows.index(False) if False in overflows else 0
    res = {"steps": len(overflows), "overflows": overflows,
           "opening_overflows": opening, "adam_launches": adam,
           "history_kept": kept, "history_zero": zeros,
           "slots_written": int((prev[0, 0] > 0).sum()),
           "loss_scale": float(eng.loss_scale)}
    print(f"  fp16 from 2^32 with the fp8 FFN: {res}", flush=True)
    ok = (opening > 0 and all(zeros[:opening]) and
          overflows.count(False) == 2 and res["slots_written"] == 2 * gas
          and all((a, k) == ((0, True) if o else (1, False))
                  for o, a, k in zip(overflows, adam, kept)))
    if not ok:
        fail(f"36(c): an overflow step must launch no Adam and keep the "
             f"history (the opening ones at zeros), a taken step launch "
             f"one Adam and write {gas} slots: {res}")
    report["train_quant_fp16"] = res
    del eng, model
    torch.cuda.empty_cache()
    return res


def quant_resume(fa, ad, report):
    """36(c), then: the fp8 FFN at 4 layers in bf16 takes 3 steps, saves
    (sync) and takes one more; a fresh engine from other seed weights
    loads the checkpoint (the history bit-equal to the saved one) and
    takes the same step: its loss and history equal the uninterrupted
    run's bit for bit."""
    import deeperspeed_tpu_torch as dst
    conf = quant_conf(TRAIN_CONFIG, "fp8")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, TRAIN_VOCAB_USED, size=(2, 16, TRAIN_SEQ))).cuda()
    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="quant_resume_", dir="build")
    try:
        model = build_model(torch.float32, num_layers=QUANT_PARITY_LAYERS)
        eng, *_ = dst.initialize(model=model, config_params=conf)
        for _ in range(QUANT_RESUME_STEPS):
            eng.train_batch(batch=(tokens, tokens))
        eng.save_checkpoint(tmp, tag="q")
        saved = eng.quant.amax.clone()
        want = eng.train_batch(batch=(tokens, tokens))
        want_amax = eng.quant.amax.clone()
        del eng, model
        model = build_model(torch.float32, seed=5,
                            num_layers=QUANT_PARITY_LAYERS)
        eng, *_ = dst.initialize(model=model, config_params=conf)
        eng.load_checkpoint(tmp, tag="q")
        loaded = torch.equal(eng.quant.amax, saved)
        fa.launches = ad.launches = 0
        got = eng.train_batch(batch=(tokens, tokens))
        launches = (fa.launches, ad.launches)
        res = {"loss_uninterrupted": want, "loss_resumed": got,
               "history_loaded_bit_equal": loaded,
               "loss_bit_identical": got == want,
               "history_bit_identical": torch.equal(eng.quant.amax,
                                                    want_amax),
               "launches": list(launches)}
        del eng, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"  save / resume with the fp8 FFN: {res}", flush=True)
    if not (loaded and res["loss_bit_identical"] and
            res["history_bit_identical"] and
            launches == (QUANT_PARITY_LAYERS * 2, 1)):
        fail(f"36(c): the resumed step is not bit-identical to the "
             f"uninterrupted one: {res}")
    report["train_quant_resume"] = res
    return res


def check_gpt2xl_qmm(qm, gen, report):
    """38, first: the int8 matmul at GPT-2 XL's four block shapes against
    its plain version, bf16 at 16 and 256 rows (two calls bit-identical,
    timed beside the plain version, torch.matmul on the dequantized
    weight and the bound) and fp32 at 16 rows (the parity's FMA
    kernel)."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for M in GPT2_XL_QMM_ROWS if dtype == torch.bfloat16 else (16,):
            for K, N in GPT2_XL_QMM_SHAPES:
                row, x, qw = qmm_case(qm, gen, M, K, N, dtype)
                if dtype == torch.bfloat16:
                    again = qm.quant_matmul_cuda(x, qw)
                    row["bit_identical"] = bool(torch.equal(
                        qm.quant_matmul_cuda(x, qw), again))
                    if not row["bit_identical"]:
                        fail(f"int8 matmul at {row}: two calls differ")
                    qmm_times(qm, gen, row, x, qw)
                rows.append(row)
                del x, qw
        torch.cuda.empty_cache()
    report["quant_matmul_gpt2xl"] = rows
    return rows


def serve_gpt2xl_int8(fa, da, qm, report):
    """Phase 38, serve-gpt2xl-int8: GPT-2 XL (seeded bf16 weights) serves
    row_quant's stream (16 requests x 62 prompt tokens x 48 new, page
    64) at the bf16 and int8w rungs (exact launches, every int8 matmul on
    the wgmma design, every decode on the cluster kernel); then the
    greedy tokens of 8 prompts with int8 weights through the kernels and
    through the plain path (every first token identical), and an fp32
    parity at XL widths and 2 layers with int8 weights (every token
    identical)."""
    from deeperspeed_tpu_torch import GPT2, GPT2Config, InferenceEngine
    model = GPT2(GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16),
                 device="cuda").init_params(6)
    cfg = model.config
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=QUANT_PROMPT))
               for _ in range(QUANT_REQUESTS)]
    rungs = {}
    for tag, weights, kv_dtype in QUANT_XL_RUNGS:
        rungs[tag] = r = serve_quant_rung(model, prompts, tag, weights,
                                          kv_dtype, fa, da, qm)
        print(f"  {tag}: decode {r['decode_tok_s']:.1f} tokens/s, stream "
              f"{r['stream_tok_s']:.1f} tokens/s, inter-token p50 "
              f"{r['inter_token_p50_ms']:.2f} ms, {r['prefill_calls']} "
              f"prefill calls, {r['decode_steps']} decode steps, launches "
              f"{r['launches']}, dtypes {r['dtypes']}", flush=True)
    lens = [9, 64, 65, 130, 200, 300, 513, 700]
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in lens]
    conf = _quant_config(SERVE_CONFIG, "int8", None)
    qm.launches = 0
    fast = InferenceEngine(model, config=conf).generate(prompts,
                                                        max_new_tokens=8)
    launched = qm.launches
    model.use_kernels = False
    plain_cfg = json.loads(json.dumps(conf))
    plain_cfg["inference"]["kernel"] = "xla"
    qm.launches = 0
    plain = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=8)
    same = [a == b for a, b in zip(fast, plain)]
    first = [a[0] == b[0] for a, b in zip(fast, plain)]
    print(f"  bf16 int8 greedy: {sum(same)}/{len(same)} requests "
          f"token-identical, {sum(first)}/{len(first)} first tokens; int8 "
          f"matmul launches {launched} (plain path {qm.launches})",
          flush=True)
    if qm.launches or not launched:
        fail(f"38: the kernel path launched {launched} int8 matmuls, the "
             f"plain path {qm.launches}")
    if not all(first):
        fail(f"38: greedy first tokens differ between the kernel path and "
             f"the plain path: {fast} vs {plain}")
    del model
    torch.cuda.empty_cache()
    small = dataclasses.replace(GPT2Config.megatron_1_5b(),
                                num_layers=QUANT_XL_PARITY_LAYERS)
    model = GPT2(small, device="cuda").init_params(7)
    prompts = [list(rng.integers(1, small.vocab_size, size=n)) for n in lens]
    qm.launches = 0
    qm.reset_design_launches()
    fast32 = InferenceEngine(model, config=conf).generate(
        prompts, max_new_tokens=16)
    design32 = dict(qm.design_launches)
    model.use_kernels = False
    plain32 = InferenceEngine(model, config=plain_cfg).generate(
        prompts, max_new_tokens=16)
    same32 = [a == b for a, b in zip(fast32, plain32)]
    print(f"  fp32 int8 parity at XL widths, {QUANT_XL_PARITY_LAYERS} "
          f"layers: {sum(same32)}/{len(same32)} requests token-identical "
          f"(int8 matmul launches by design {design32})", flush=True)
    if not all(same32) or not design32["fma"] or design32["wgmma"]:
        fail(f"38: fp32 int8 greedy tokens differ between the kernel path "
             f"and the plain path ({design32}): {fast32} vs {plain32}")
    del model
    torch.cuda.empty_cache()
    res = {"rungs": rungs,
           "int8w_decode_vs_bf16": rungs["int8w"]["decode_tok_s"] /
           rungs["bf16"]["decode_tok_s"],
           "greedy_bf16": {"prompt_lengths": lens, "identical": same,
                           "first_token_identical": first,
                           "kernel_launches": launched},
           "parity_fp32": {"layers": QUANT_XL_PARITY_LAYERS,
                           "identical": same32,
                           "design_launches": design32}}
    report["serve_gpt2xl_int8"] = res
    return res


def run_quant_phases(fa, ad, gm, da, qm, report, card, bf16, moe):
    """Phases 36-38 → (36, its int8 rung, 37, 38 results, the XL int8
    matmul rows); ``bf16`` and ``moe`` are phases 7 and 11 of this run,
    for the numbers beside."""
    print(f"quantized training train-fp8ffn-125M (phase 7's rung with the "
          f"fp8 FFN, amax history {QUANT_HISTORY}) on {card}:", flush=True)
    tq = train(fa, ad, report, conf=quant_conf(TRAIN_CONFIG, "fp8"),
               key="train_fp8ffn")
    print_train("train-fp8ffn-125M", tq, card, beside=bf16)
    print("train-int8ffn-125M (the int8 recipe):", flush=True)
    ti = train(fa, ad, report, conf=quant_conf(TRAIN_CONFIG, "int8"),
               key="train_int8ffn", steps=QUANT_INT8_STEPS, fall=1.0)
    print_train("train-int8ffn-125M", ti, card, beside=bf16)
    print("quantized training parity (fp32, 4 layers, kernels vs plain):",
          flush=True)
    fake_quant_on_card(report)
    quant_train_parity(fa, ad, report)
    print("quantized training in fp16 and across a checkpoint (4 layers):",
          flush=True)
    quant_fp16_overflow(fa, ad, report)
    quant_resume(fa, ad, report)
    print(f"quantized MoE training train-moe-125M-int8ffn (phase 11's rung "
          f"with the int8 FFN) on {card}:", flush=True)
    tm = train(fa, ad, report, conf=quant_conf(MOE_TRAIN_CONFIG, "int8"),
               gm=gm, key="train_moe_int8ffn", steps=QUANT_MOE_STEPS,
               fall_last=3)
    print_train("train-moe-125M-int8ffn", tm, card, beside=moe)
    print(f"serve-gpt2xl-int8 (GPT-2 XL, int8 block weights, row_quant's "
          f"stream) on {card}:", flush=True)
    xq = check_gpt2xl_qmm(qm, torch.Generator(device="cuda").manual_seed(38),
                          report)
    sx = serve_gpt2xl_int8(fa, da, qm, report)
    return tq, ti, tm, sx, xq


def quant_kernel_entries(tq, ti, tm, sx, xq):
    """What phases 36-38 add to the kernels line: each kernel's launches
    on them by path, and the int8 matmul's GPT-2 XL shapes."""
    train_paths = {"train_fp8ffn": tq, "train_int8ffn": ti,
                   "train_moe_int8ffn": tm}

    def by_path(name, paths=train_paths):
        return {p: r["launches"][name] for p, r in paths.items()}
    xl = {t: r for t, r in sx["rungs"].items()}
    return {
        "flash_fwd": by_path("flash_fwd") | {
            f"serve_gpt2xl_{t}": r["launches"]["flash_fwd"]
            for t, r in xl.items()},
        "flash_bwd": by_path("flash_bwd_dkv"),
        "flash_bwd_dq": by_path("flash_bwd_dq"),
        "adam": by_path("adam"),
        "grouped_matmul": {"train_moe_int8ffn":
                           tm["launches"]["grouped_matmul"]},
        "grouped_matmul_dw": {"train_moe_int8ffn":
                              tm["launches"]["grouped_matmul_dw"]},
        "paged_decode": {f"serve_gpt2xl_{t}": r["launches"]["paged_decode"]
                         for t, r in xl.items()},
        "quant_matmul": {"serve_gpt2xl_int8w":
                         xl["int8w"]["launches"]["quant_matmul"]},
        "quant_matmul_design": {"serve_gpt2xl_int8w": xl["int8w"][
            "quant_matmul_design_launches"]},
        "quant_matmul_gpt2xl_shapes": [{k: r[k] for k in (
            "M", "K", "N", "dtype", "plan", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")} | graph_times(r)
            for r in xq if "ms" in r],
    }


def merge_quant_entries(kernels, entries):
    """Add phases 36-38's launches to the kernels line's rows (their
    totals and ``launches_by_path``) and the XL shapes to the int8
    matmul's row."""
    rows = {r["name"]: r for r in kernels}
    for name in ("flash_fwd", "flash_bwd", "adam", "grouped_matmul",
                 "grouped_matmul_dw", "paged_decode", "quant_matmul"):
        paths = entries[name]
        row = rows[name]
        row["launches"] += sum(paths.values())
        row.setdefault("launches_by_path", {}).update(paths)
    by_kernel = rows["flash_bwd"].setdefault("launches_by_kernel",
                                             {"dkv": 0, "dq": 0})
    by_kernel["dkv"] += sum(entries["flash_bwd"].values())
    by_kernel["dq"] += sum(entries["flash_bwd_dq"].values())
    rows["quant_matmul"]["design_launches_gpt2xl"] = entries[
        "quant_matmul_design"]
    rows["quant_matmul"]["gpt2xl_shapes"] = entries[
        "quant_matmul_gpt2xl_shapes"]


def _row_nums(r, err):
    return {"max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}


def train_kernel_rows(ft, fb, adm, gmm, entries):
    """The kernels line's training rows of a partial run (flash forward
    and backward, Adam, the grouped matmul and its dW; without the last
    two when ``gmm`` is None): phase 3's training-shape numbers and the
    launches ``entries`` gives by path."""
    pallas = "deeperspeed_tpu/ops/pallas/"
    train_shape = "B=16 S=1024 H=12 D=64 bf16, causal"
    nums = _row_nums

    def total(name):
        return sum(entries[name].values())
    rows = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{pallas}flash_attention.py:497 (_fwd_kernel)",
         "launches": total("flash_fwd"),
         "launches_by_path": entries["flash_fwd"],
         **nums(ft, ft["max_abs_err_out"]), "shape": train_shape},
        {"name": "flash_bwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{pallas}flash_attention.py:948, :1038 "
                     f"(_bwd_dkv_kernel, _bwd_dq_kernel)",
         "launches": total("flash_bwd"),
         "launches_by_kernel": {"dkv": total("flash_bwd"),
                                "dq": total("flash_bwd_dq")},
         **nums(fb, max(fb[f"max_abs_err_{g}"] for g in ("dq", "dk", "dv"))),
         "shape": train_shape + " (dkv + dq kernels)"},
        {"name": "adam", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/adam.cu",
         "replaces": f"{pallas}optimizer.py:34 (_adam_kernel)",
         "launches": total("adam"), "launches_by_path": entries["adam"],
         **nums(adm, adm["max_abs_err_p"]),
         "shape": "GPT-NeoX-125M's parameters, fp32 p/m/v, bf16 g, bf16 "
                  "copy"}]
    if gmm is None:
        return rows
    return rows + [
        {"name": "grouped_matmul", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:121 (_fwd_kernel; also dx)",
         "launches": total("grouped_matmul"),
         **nums(gmm[0], gmm[0]["max_abs_err"]), "shape": gmm_shape(gmm[0])},
        {"name": "grouped_matmul_dw", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:174 (_dw_kernel)",
         "launches": total("grouped_matmul_dw"),
         "max_abs_err": gmm[0]["max_abs_err_dw"], "ms": gmm[0]["dw_ms"],
         "plain_ms": gmm[0]["dw_plain_ms"],
         "bound_ms": gmm[0]["dw_bound_ms"],
         "bound_by": gmm[0]["dw_bound_by"],
         "library_ms": gmm[0]["dw_library_ms"],
         "shape": gmm_shape(gmm[0]) + ", fp32 dW"},
    ]


def quant_kernel_rows(ft, fb, adm, gmm, xq, entries):
    """The kernels line of ``--quant-train-only``: the kernels phases
    36-38 launch, with phase 3's training-shape numbers (the int8
    matmul's at GPT-2 XL's qkv shape, 16 rows) and their launches on
    phases 36-38. The paged decode kernel, which phase 38 also launches,
    is held and timed by the full run's phase 3."""
    pallas = "deeperspeed_tpu/ops/pallas/"
    q0 = next(r for r in xq if "ms" in r)
    return train_kernel_rows(ft, fb, adm, gmm, entries) + [
        {"name": "quant_matmul", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/quant_matmul.cu",
         "replaces": f"{pallas}quant_matmul.py:152 (_wq_kernel)",
         "launches": sum(entries["quant_matmul"].values()),
         "launches_by_path": entries["quant_matmul"],
         "design_launches": entries["quant_matmul_design"],
         **_row_nums(q0, q0["max_abs_err"]),
         "library": "torch.matmul on the dequantized bf16 weight",
         "shape": f"M={q0['M']} K={q0['K']} N={q0['N']} bf16 (GPT-2 XL "
                  f"qkv, a decode step)",
         "gpt2xl_shapes": entries["quant_matmul_gpt2xl_shapes"]},
    ]


def quant_train_only(card):
    """Phases 36-38 alone, after phase 3's training-shape flash, Adam and
    grouped-matmul checks and phases 7 and 11 (the step, tokens/s and
    MFU beside phases 36 and 37)."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (training shapes):", flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    gmm = check_grouped_matmul(gm, gen, report)
    print("training GPT-NeoX-125M (bf16, phase 7):", flush=True)
    tr = train(fa, ad, report)
    print_train("train-125M", tr, card)
    print("MoE training GPT-NeoX-125M (phase 11):", flush=True)
    tm = train(fa, ad, report, conf=MOE_TRAIN_CONFIG, gm=gm,
               key="train_moe")
    print_train("train-moe-125M", tm, card)
    qres = run_quant_phases(fa, ad, gm, da, qm, report, card, bf16=tr,
                            moe=tm)
    report["kernels"] = quant_kernel_rows(ft, fb, adm, gmm, qres[-1],
                                          quant_kernel_entries(*qres))
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_quant.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 39: observability (train-telemetry-125M, serve-telemetry-125M)
# ---------------------------------------------------------------------------

# bench.py row_telemetry's rungs: phase 7's model behind the row's JSON
# (SENTINEL_BASE: bf16, ZeRO-2, gas 1, Adam lr 1e-4) at micro 16 and 8,
# 3 warm-up and 8 timed steps with the telemetry block off and then on
# (goodput, mfu, spans; capture off); tensorboard on in both
TELEMETRY_RUNGS = (16, 8)
TELEMETRY_WARMUP, TELEMETRY_STEPS = 3, 8
# then the two engines take turns, 8 steps at a time, for this many
# rounds in alternating order (as phase 29's rounds): the medians
TELEMETRY_ROUNDS = 4
TELEMETRY_ON = {"enabled": True, "goodput": True, "mfu": True,
                "spans": True}
# steps counted for synchronizing calls right after a flush: fewer than
# the monitor's flush interval (10 records) at two records a step
TELEMETRY_SYNC_STEPS = 3
# the bar the JAX row sets for the overhead with capture off (percent);
# printed, not gated (host-bound steps spread 5-10%, PERF.md §7)
TELEMETRY_BAR_PCT = 1.0
# the in-engine MFU divides by the step windows, the analytic one by the
# whole loop: the gate holds the Train/Samples/mfu scalars to the counted
# flops over the step windows this script stamps itself (so the ratio to
# the analytic MFU to the shapes' ratio x loop / windows); the ratio
# against the shapes' ratio alone, the prediction, is printed
TELEMETRY_MFU_TOL = 0.02
TELEMETRY_CAPTURE_BS = 8
TELEMETRY_MOE_STEPS = 6
# 39(f): phase 13's engine (2 x 16,384 tokens) with the telemetry block,
# beside it without: one step each, and the most the peak of allocated
# memory may rise with telemetry on (allocator noise; the count's old
# real plain pass held fp32 [2, 12, 16384, 16384] scores, 24 GiB each)
TELEMETRY_LONG_STEPS = 1
TELEMETRY_LONG_MEM_SLACK = 256 * 2 ** 20
# 39(c): phase 4's stream through the engine without telemetry and the
# one with it, taking turns in alternating order this many rounds
SERVE_TELEMETRY_ROUNDS = 4
TELEMETRY_SPANS = ("h2d", "train_dispatch")
SPAN_NAMES = TELEMETRY_SPANS + ("data_fetch", "sentinel", "ckpt_snapshot",
                                "rollback_restore")
KERNEL_FRAGMENTS = {"flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd",
                    "adam": "adam_kernel"}


def tb_available():
    from deeperspeed_tpu_torch.runtime import monitor
    return monitor._HAVE_TB


def tb_block(tmp, tag):
    return {"tensorboard": {"enabled": True, "output_path": tmp,
                            "job_name": tag}}


def listen(monitor):
    """Keep every record the monitor gets (sample, scalars), beside its
    own queue."""
    records = []
    record = monitor.record

    def recorded(sample, scalars):
        records.append((sample, dict(scalars)))
        return record(sample, scalars)

    monitor.record = recorded
    return records


def stamp_windows(tel):
    """Stamp the host clock where the telemetry opens and closes each
    step window; the returned list holds each window's seconds."""
    windows, opened = [], []
    start, end = tel.on_step_start, tel.on_step_end

    def on_step_start(*a, **k):
        opened.append(time.perf_counter())
        return start(*a, **k)

    def on_step_end(*a, **k):
        windows.append(time.perf_counter() - opened.pop())
        return end(*a, **k)
    tel.on_step_start, tel.on_step_end = on_step_start, on_step_end
    return windows


def count_syncs(fn):
    """Synchronizing CUDA calls made by ``fn()``, read with
    `torch.cuda.set_sync_debug_mode("warn")` (one warning a call; the
    mode's own notice that it is a prototype, given once a process, is
    not a call)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def kernels_one_step(eng, batch):
    """The device kernels of one `train_batch` step, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        eng.train_batch(batch=batch)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        # the spans' record_functions also get a device-side range
        if e.device_type == DeviceType.CUDA and not (
                e.name.startswith("train_step") or e.name in SPAN_NAMES):
            names[e.name] = names.get(e.name, 0) + 1
    return names


def gemm_launches(names):
    return sum(n for name, n in names.items()
               if any(f in name.lower()
                      for f in ("gemm", "xmma", "cutlass", "nvjet")))


def shape_flops(bs, model=NEOX_125M, seq=None):
    """The flops profiler's count of one GPT-NeoX step of ``model`` at
    micro ``bs`` (gas 1) and ``seq`` tokens (TRAIN_SEQ by default), from
    the shapes: the block matmuls (12·h² weights a layer) and the head
    over the S - 1 labelled positions, 2 products forward and 4
    backward; attention QKᵀ and P·V over the full S×S square (a block
    layout too: the plain version computes the square, then masks); the
    embedding gather none."""
    h, L, V = model["hidden_size"], model["num_layers"], model["vocab_size"]
    seq = TRAIN_SEQ if seq is None else seq
    return (72 * L * h * h * bs * seq + 6 * h * V * bs * (seq - 1) +
            12 * L * bs * seq * seq * h)


def telemetry_rung(ledger, bs, tmp):
    """39(a): row_telemetry's rung at micro ``bs``: a fresh engine with
    the telemetry block off, then one with it on, 3 warm-up and 8 timed
    steps each (host ms a step between device syncs: the JAX row's
    printout); then the two take turns for TELEMETRY_ROUNDS blocks of 8
    steps each, in alternating order (the medians: the overhead from one
    card). Then, on each engine: the synchronizing CUDA calls of
    TELEMETRY_SYNC_STEPS steps right after a monitor flush, and the
    kernels of one profiled step (flash, Adam and cuBLAS launches). The
    in-engine MFU (from the Train/Samples/mfu scalars of the 8 timed
    steps: their flops over the sum of their step windows) against the
    analytic one (tokens/s over the loop x (6N + 12·L·h·S) / peak): the
    gate holds it to the counted flops over the step windows stamped
    here; the ratio to the analytic MFU against the ratio the shapes fix
    (the prediction) is printed, with the host time of the loop outside
    the windows, inside the train_batch calls and between them."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    tokens = sentinel_tokens(bs)[0]
    batch = (tokens, tokens)
    row, syncs, kern, engines = {}, {}, {}, {}
    for tag, tel in (("off", None), ("on", TELEMETRY_ON)):
        blocks = tb_block(os.path.join(tmp, f"bs{bs}"), tag)
        if tel is not None:
            blocks["telemetry"] = tel
        eng = engines[tag] = sentinel_engine(bs, extra=blocks)
        records = listen(eng.monitor)
        windows = stamp_windows(eng.telemetry) if tel is not None else []
        ledger.reset()
        for _ in range(TELEMETRY_WARMUP):
            eng.train_batch(batch=batch)
        records.clear()
        windows.clear()
        calls_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TELEMETRY_STEPS):
            c0 = time.perf_counter()
            loss = eng.train_batch(batch=batch)
            calls_s += time.perf_counter() - c0
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        row[tag] = loop_s * 1e3 / TELEMETRY_STEPS
        if tel is not None:
            timed, windows_s = list(records), sum(windows)
            on_calls_s, on_loop_s = calls_s, loop_s
        n = TELEMETRY_WARMUP + TELEMETRY_STEPS
        ledger.check(f"train-telemetry bs {bs} {tag}", n, n)
        if not np.isfinite(loss):
            fail(f"train-telemetry bs {bs} {tag}: loss {loss}")
    # the two engines take turns, 8 steps at a time, in alternating
    # order: the medians give the overhead from one card
    rounds = {tag: [] for tag in engines}
    for r in range(TELEMETRY_ROUNDS):
        for tag in (("off", "on") if r % 2 == 0 else ("on", "off")):
            ledger.reset()
            ms, _ = sentinel_steps(engines[tag], batch, TELEMETRY_STEPS)
            ledger.check(f"train-telemetry bs {bs} {tag} round {r}",
                         TELEMETRY_STEPS, TELEMETRY_STEPS)
            rounds[tag].append(ms)
    med = {tag: float(np.median(v)) for tag, v in rounds.items()}
    for tag, eng in engines.items():
        eng.monitor.flush()

        def steps(eng=eng):
            for _ in range(TELEMETRY_SYNC_STEPS):
                eng.train_batch(batch=batch)
        flushes = eng.monitor.flushes
        syncs[tag] = count_syncs(steps)
        eng.monitor.wait()
        if eng.monitor.flushes != flushes:
            fail(f"train-telemetry bs {bs} {tag}: the monitor flushed "
                 f"inside the sync count")
        ledger.reset()
        kern[tag] = kernels_one_step(eng, batch)
        ledger.check(f"train-telemetry bs {bs} {tag} profiled", 1, 1)
        if tag == "on":
            flops = eng.telemetry.compiled_flops.get(1)
            goodput = eng.telemetry.goodput.scalars()
        eng.monitor.close()
    del engines, eng
    free_cuda()
    if syncs["on"] > syncs["off"]:
        fail(f"train-telemetry bs {bs}: {syncs['on']} synchronizing calls "
             f"in {TELEMETRY_SYNC_STEPS} steps with telemetry on, "
             f"{syncs['off']} off")
    launches = {tag: {k: sum(v for n, v in names.items() if frag in n)
                      for k, frag in KERNEL_FRAGMENTS.items()} |
                {"cublas": gemm_launches(names),
                 "all": sum(names.values())}
                for tag, names in kern.items()}
    for k in ("flash_fwd", "flash_bwd", "adam", "cublas"):
        if launches["on"][k] != launches["off"][k]:
            fail(f"train-telemetry bs {bs}: {k} launches a step "
                 f"{launches['on'][k]} with telemetry on, "
                 f"{launches['off'][k]} off")
    want_flops = shape_flops(bs)
    if flops != want_flops:
        fail(f"train-telemetry bs {bs}: counted flops {flops} != "
             f"{want_flops} from the shapes")
    mfu = [s["Train/Samples/mfu"] for _, s in timed
           if "Train/Samples/mfu" in s]
    if len(mfu) != TELEMETRY_STEPS:
        fail(f"train-telemetry bs {bs}: {len(mfu)} mfu scalars in "
             f"{TELEMETRY_STEPS} steps")
    cfg = GPTNeoXConfig(**NEOX_125M)
    ftok = neox_ftok(cfg, TRAIN_SEQ)
    # the steps' flops over the sum of their step windows (each window
    # from its scalar), as the analytic MFU is over the loop
    mfu_engine = len(mfu) / sum(1 / m for m in mfu)
    mfu_stamped = flops * len(mfu) / windows_s / PEAK_FLOPS_S
    mfu_analytic = bs * TRAIN_SEQ / (row["on"] / 1e3) * ftok / PEAK_FLOPS_S
    shape_ratio = want_flops / (bs * TRAIN_SEQ * ftok)
    ratio = mfu_engine / mfu_analytic
    explained = shape_ratio * on_loop_s / windows_s
    if abs(mfu_engine / mfu_stamped - 1) > TELEMETRY_MFU_TOL:
        fail(f"train-telemetry bs {bs}: in-engine MFU {mfu_engine:.4f} "
             f"against {mfu_stamped:.4f} from the counted flops over the "
             f"stamped step windows ({windows_s * 1e3:.2f} ms in "
             f"{TELEMETRY_STEPS} steps)")
    per_step = 1e3 / TELEMETRY_STEPS
    return {
        "telemetry_step_ms_off": row["off"],
        "telemetry_step_ms_on": row["on"],
        "telemetry_overhead_pct": (row["on"] - row["off"]) / row["off"] * 100,
        "step_ms_rounds": rounds, "step_ms_median": med,
        "overhead_pct_median": (med["on"] / med["off"] - 1) * 100,
        "telemetry_mfu_in_engine": mfu_engine,
        "telemetry_mfu_stamped_windows": mfu_stamped,
        "telemetry_mfu_analytic": mfu_analytic,
        "telemetry_mfu_ratio": ratio,
        "telemetry_mfu_ratio_shapes": shape_ratio,
        "telemetry_mfu_ratio_shapes_x_loop_over_windows": explained,
        "telemetry_mfu_ratio_off_pct": (ratio / shape_ratio - 1) * 100,
        "telemetry_mfu_ratio_within_prediction":
            abs(ratio / shape_ratio - 1) <= TELEMETRY_MFU_TOL,
        "step_window_ms": windows_s * per_step,
        "host_ms_in_calls_outside_windows": (on_calls_s - windows_s) *
        per_step,
        "host_ms_between_calls": (on_loop_s - on_calls_s) * per_step,
        "telemetry_flops_per_step": flops,
        "telemetry_goodput_fraction": goodput["Train/Goodput/fraction"],
        "goodput": goodput,
        "syncs_per_window": syncs, "sync_window_steps": TELEMETRY_SYNC_STEPS,
        "tensorboardX": tb_available(),
        "launches_per_step": launches,
        "kernels_on_not_off": {n: kern["on"][n] - kern["off"].get(n, 0)
                               for n in kern["on"]
                               if kern["on"][n] != kern["off"].get(n, 0)},
        "scalar_tags": sorted({t for _, s in timed for t in s}),
    }


def telemetry_long_seq(fa, ad, tmp):
    """39(f): phase 13's engine (train-sparse-125M-16k: micro 2 x 16,384
    tokens, the block-sparse arm) with the telemetry block (goodput,
    mfu, spans, memory watermarks each step) and tensorboard, beside the
    same engine without the telemetry block, TELEMETRY_LONG_STEPS steps
    each from a reset of the peak (their wall seconds: the difference
    is mostly the count's host time): the step variant's flops, counted
    over fake tensors, equal the count from the shapes (the block-sparse
    plain version: each query block against its LUT's width of key
    blocks, 2 products forward and 5 backward), the block-sparse
    launches are exact, and the peak of allocated memory above what the
    engine held before its first step is the telemetry-off engine's
    within TELEMETRY_LONG_MEM_SLACK."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    micro = SPARSE_TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, SPARSE_MODEL["vocab_size"], size=(1, micro, SPARSE_SEQ))).cuda()
    L, h = SPARSE_MODEL["num_layers"], SPARSE_MODEL["hidden_size"]
    out = {}
    for tag in ("off", "on"):
        model = GPTNeoX(GPTNeoXConfig(**SPARSE_MODEL), device="cuda")
        model.init_params(5)
        conf = {**SPARSE_TRAIN_CONFIG, **tb_block(tmp, f"long_{tag}")}
        if tag == "on":
            conf["telemetry"] = {**TELEMETRY_ON,
                                 "memory_watermark_interval_steps": 1}
        eng, *_ = dst.initialize(model=model, config_params=conf)
        records = listen(eng.monitor)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_attention_counts(fa, bsa)
        ad.reset_launches()
        t0 = time.perf_counter()
        losses = [eng.train_batch(batch=(tokens, tokens))
                  for _ in range(TELEMETRY_LONG_STEPS)]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        launches = dict(attention_counts(fa, bsa), adam=ad.launches)
        n = TELEMETRY_LONG_STEPS
        want = {k: 0 for k in launches}
        want.update(block_sparse_fwd=L * n, block_sparse_dkv=L * n,
                    block_sparse_dq=L * n, adam=n)
        if launches != want or not all(np.isfinite(losses)):
            fail(f"train-telemetry-16k {tag}: launches {launches} != "
                 f"{want} or losses {losses} not finite")
        out[tag] = {"peak_above_held_bytes": peak, "losses": losses,
                    "launches": launches, "steps_wall_s": wall_s}
        if tag == "on":
            lut = model.sparse_self_attention.get_layout(
                SPARSE_SEQ)[1].luts.fwd[0]
            V = SPARSE_MODEL["vocab_size"]
            want_flops = (72 * L * h * h * micro * SPARSE_SEQ +
                          6 * h * V * micro * (SPARSE_SEQ - 1) +
                          14 * L * micro * (SPARSE_SEQ // 128) *
                          lut.shape[-1] * 128 * 128 * h)
            flops = eng.telemetry.compiled_flops.get(1)
            if flops != want_flops:
                fail(f"train-telemetry-16k: counted flops {flops} != "
                     f"{want_flops} from the shapes")
            marks = [s["Train/Memory/hbm_peak_bytes"] for _, s in records
                     if "Train/Memory/hbm_peak_bytes" in s]
            mfu = [s["Train/Samples/mfu"] for _, s in records
                   if "Train/Samples/mfu" in s]
            if len(marks) != n or len(mfu) != n:
                fail(f"train-telemetry-16k: {len(marks)} memory and "
                     f"{len(mfu)} mfu scalars in {n} steps")
            out["on"].update(flops=flops, lut_width=int(lut.shape[-1]),
                             hbm_peak_bytes=marks, mfu=mfu)
        eng.monitor.close()
        del eng, model
        free_cuda()
    rise = out["on"]["peak_above_held_bytes"] - \
        out["off"]["peak_above_held_bytes"]
    out["peak_rise_bytes"] = rise
    if rise > TELEMETRY_LONG_MEM_SLACK:
        fail(f"train-telemetry-16k: telemetry on raised the peak of "
             f"allocated memory by {rise / 2 ** 20:.1f} MiB")
    return out


def trace_kernels_in_spans(path):
    """From an exported torch.profiler Chrome trace: the user-annotation
    spans by name, and for each kernel family the launches whose runtime
    call lies inside a train_dispatch span and those outside."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = sorted({e["name"] for e in spans})
    dispatch = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                if e["name"] == "train_dispatch"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and
                 "correlation" in e.get("args", {})}
    inside = {k: [0, 0] for k in KERNEL_FRAGMENTS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k, frag in KERNEL_FRAGMENTS.items():
            if frag in e["name"]:
                ts = launch_ts.get(e.get("args", {}).get("correlation"))
                hit = ts is not None and any(a <= ts <= b
                                             for a, b in dispatch)
                inside[k][0 if hit else 1] += 1
    return names, inside


def telemetry_capture(ledger, tmp):
    """39(b): a capture window of 2 steps (trace_dir, capture
    {start_step 3, num_steps 2}) on the micro-8 rung with the sentinel
    under policy "warn" and capture_on_anomaly: the exported
    torch.profiler trace must hold the spans and the flash and Adam
    kernels launched inside train_dispatch. Then NaN gradients (and so a
    NaN loss) at serial 6 for 2 steps: exactly one memory snapshot and
    one armed window for the episode."""
    bs = TELEMETRY_CAPTURE_BS
    trace_dir = os.path.join(tmp, "trace")
    # warmup_steps past the run: the probe's z-scores stay quiet while
    # the loss falls fast, so the NaN steps are the only episode
    th = {"enabled": True, "policy": "warn", "warmup_steps": 100,
          "fault_injection": {"faults": [{"kind": "nan_grads", "step": 6,
                                          "times": 2}]}}
    eng = sentinel_engine(bs, th=th, extra={**tb_block(tmp, "capture"),
                          "telemetry": {**TELEMETRY_ON,
                                        "trace_dir": trace_dir,
                                        "capture": {"start_step": 3,
                                                    "num_steps": 2},
                                        "capture_on_anomaly": True}})
    tokens = sentinel_tokens(bs)[0]
    ledger.reset()
    steps = 9
    for _ in range(steps):
        eng.train_batch(batch=(tokens, tokens))
    torch.cuda.synchronize()
    ledger.check("train-telemetry capture", steps, steps)
    tel = eng.telemetry
    scheduled = os.path.join(trace_dir, "torch_trace_step3.json")
    if not os.path.isfile(scheduled):
        fail(f"no torch.profiler trace at {scheduled}: "
             f"{tel.profiler_traces}")
    names, inside = trace_kernels_in_spans(scheduled)
    missing = [s for s in TELEMETRY_SPANS if s not in names]
    if missing or not {"train_step3", "train_step4"} & set(names):
        fail(f"the capture trace lacks the spans {missing} or a step of "
             f"the window (has {names})")
    for k, (hit, miss) in inside.items():
        if not hit or miss:
            fail(f"the capture trace: {k} kernels {hit} inside "
                 f"train_dispatch, {miss} outside")
    spans = json.load(open(os.path.join(trace_dir, "spans_step3.json")))
    if tel.anomaly_captures != 1 or len(tel.memory_snapshots) != 1 or \
            tel.windows_opened != 2:
        fail(f"the NaN episode gave {tel.anomaly_captures} captures, "
             f"{len(tel.memory_snapshots)} memory snapshots, "
             f"{tel.windows_opened} windows (the scheduled one included)")
    snap = json.load(open(tel.memory_snapshots[0]))
    if "nonfinite" not in snap["tag"]:
        fail(f"the anomaly episode is not the NaN one: {snap['tag']}")
    dev = next(iter(snap["devices"].values()))
    if not dev.get("bytes_in_use"):
        fail(f"the memory snapshot holds no device bytes: {snap}")
    result = {"spans_in_trace": names, "kernels_inside_dispatch": inside,
              "span_events_exported": len(spans["traceEvents"]),
              "dispatch_in_trace": spans["otherData"]["dispatch"],
              "anomaly_captures": tel.anomaly_captures,
              "memory_snapshot": snap["tag"],
              "memory_bytes_in_use": dev.get("bytes_in_use"),
              "windows_opened": tel.windows_opened,
              "traces": [os.path.basename(p) for p in tel.profiler_traces],
              "anomalies": eng.sentinel.anomalies}
    eng.monitor.close()
    del eng
    free_cuda()
    return result


def serve_telemetry(fa, da, report, sv=None):
    """39(c): phase 4's serve-125M stream with a "telemetry" block and a
    monitor with a Prometheus port (0: ephemeral, on 127.0.0.1): the
    spans schedule / prefill / decode, the Serve/* scalars, a scrape
    that renders the TTFT and inter-token histograms, `drain` flushing
    and closing the owned monitor, and the first tokens equal to phase
    4's (``sv``; run here without telemetry when not given)."""
    from deeperspeed_tpu_torch.runtime.monitor import TensorBoardMonitor
    if sv is None:
        sv = serve(fa, da, report, key="serve_phase4_beside")
    tmp = tempfile.mkdtemp(prefix="ds_serve_telemetry_", dir="build")
    monitor = TensorBoardMonitor(output_path=tmp, job_name="serve",
                                 export={"prometheus_port": 0})
    records = listen(monitor)
    conf = {**SERVE_CONFIG, "telemetry": TELEMETRY_ON}

    def check(eng):
        import urllib.request
        phases = sorted(eng.telemetry.tracer.drain_phases())
        if phases != ["decode", "prefill", "schedule"]:
            fail(f"serve-telemetry spans {phases}")
        port = monitor.prometheus.port
        # no proxy: the scrape stays on this host whatever the
        # environment's http_proxy says
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        body = opener.open(f"http://127.0.0.1:{port}/metrics",
                           timeout=30).read().decode()
        for fam in ("ds_serve_ttft_ms_bucket", "ds_serve_inter_token_ms_"
                    "bucket", "ds_serve_ttft_ms_count",
                    "ds_serve_inter_token_ms_count"):
            if fam not in body:
                fail(f"the scrape has no {fam}")
        pending = len(monitor._pending)
        flushes = monitor.flushes
        eng.drain()
        if monitor.writer is not None or monitor._pending or \
                (pending and monitor.flushes == flushes):
            fail("drain did not flush and close the owned monitor")
        tags = sorted({t for _, s in records for t in s})
        want = {"Serve/queue_depth", "Serve/page_pool_util",
                "Serve/running", "Serve/requests_ok", "Serve/ttft_p50_ms"}
        if not want <= set(tags):
            fail(f"serve-telemetry: Serve/* scalars {tags} lack "
                 f"{sorted(want - set(tags))}")
        return {"spans": phases, "serve_tags": tags,
                "records": len(records), "scrape_bytes": len(body),
                "scrape_ttft_count": next(
                    line for line in body.splitlines()
                    if line.startswith("ds_serve_ttft_ms_count"))}

    st = serve(fa, da, report, key="serve_telemetry", conf=conf,
               monitor=monitor, check=check)
    first = [t[0] for t in st["tokens"]]
    if first != [t[0] for t in sv["tokens"]]:
        fail("serve-telemetry: the first tokens differ from phase 4's")
    st["same_tokens_as_phase4"] = st["tokens"] == sv["tokens"]
    shutil.rmtree(tmp, ignore_errors=True)
    return st


def serve_stream(eng, prompts, max_new):
    """Phase 4's submission pattern (one request every two engine steps)
    through ``eng`` → (generated tokens/s, engine steps, the tokens of
    each request in submission order)."""
    ids, submitted, step = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while submitted < len(prompts) or eng.scheduler.has_work:
        while submitted < len(prompts) and submitted * 2 <= step:
            ids.append(eng.submit(prompts[submitted],
                                  max_new_tokens=max_new))
            submitted += 1
        if eng.scheduler.has_work:
            eng.step()
        step += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_id = {r.request_id: r for r in eng.scheduler.finished}
    tokens = [list(by_id[i].generated) for i in ids]
    return sum(map(len, tokens)) / dt, step, tokens


def serve_overhead(tmp):
    """39(c) beside: phase 4's stream through an engine without the
    telemetry block and one with it and a monitor serving Prometheus (as
    39(c)), on one bf16 model, SERVE_TELEMETRY_ROUNDS rounds taking
    turns in alternating order: the median tokens/s of each and the
    overhead; the host µs a step of the Serve/* scalars
    (`_record_serve_scalars`, timed on the engine with telemetry), and
    of one span (schedule, prefill and decode each enter one a step
    where they run), timed over 2000 empty spans. Both engines give
    the same tokens every round."""
    from deeperspeed_tpu_torch import InferenceEngine
    from deeperspeed_tpu_torch.runtime.monitor import TensorBoardMonitor
    model = build_model(torch.bfloat16)
    rng, prompts = serve_prompts(model.config)
    monitor = TensorBoardMonitor(output_path=tmp, job_name="serve_rounds",
                                 export={"prometheus_port": 0})
    engines = {"off": InferenceEngine(model, config=SERVE_CONFIG),
               "on": InferenceEngine(
                   model, config={**SERVE_CONFIG, "telemetry": TELEMETRY_ON},
                   monitor=monitor, owns_monitor=True)}
    for eng in engines.values():
        warm_buckets(eng, rng, model.config.vocab_size)
    on = engines["on"]
    scalar_s = []
    record = on._record_serve_scalars

    def timed_record():
        t0 = time.perf_counter()
        record()
        scalar_s.append(time.perf_counter() - t0)
    on._record_serve_scalars = timed_record
    rounds = {tag: [] for tag in engines}
    steps, first = {}, None
    for r in range(SERVE_TELEMETRY_ROUNDS):
        for tag in (("off", "on") if r % 2 == 0 else ("on", "off")):
            tps, steps[tag], tokens = serve_stream(engines[tag], prompts, 32)
            rounds[tag].append(tps)
            first = tokens if first is None else first
            if tokens != first:
                fail(f"serve-telemetry rounds: round {r} {tag} tokens "
                     f"differ from the first stream's")
    tel = on.telemetry
    tel.tracer.drain_phases()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with tel.span("decode"):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    tel.tracer.drain_phases()
    for eng in engines.values():
        eng.drain()
    del engines, on, eng, model
    free_cuda()
    med = {tag: float(np.median(v)) for tag, v in rounds.items()}
    return {"tokens_per_s_rounds": rounds, "tokens_per_s_median": med,
            "overhead_pct_median": (med["off"] / med["on"] - 1) * 100,
            "engine_steps_a_stream": steps,
            "serve_scalars_us_a_step": float(np.mean(scalar_s)) * 1e6,
            "serve_scalar_records": len(scalar_s),
            "span_us": span_us}


def train_moe_observability(fa, ad, gm, report, tmp):
    """39(d): phase 11's MoE rung with moe.observability and tensorboard
    on, TELEMETRY_MOE_STEPS steps: the four Train/MoE/* scalars at every
    step record, min ≤ 1/E ≤ max, the drop fraction in [0, 1)."""
    moe = {**MOE_BLOCK, "observability": True}
    conf = {**MOE_TRAIN_CONFIG, "moe": moe, **tb_block(tmp, "moe")}
    held = {}

    def on_engine(eng):
        held["records"] = listen(eng.monitor)
    tm = train(fa, ad, report, conf=conf, gm=gm, key="train_moe_obs",
               steps=TELEMETRY_MOE_STEPS, fall=1.0, fall_last=3,
               on_engine=on_engine)
    tags = ("Train/MoE/expert_load_min", "Train/MoE/expert_load_max",
            "Train/MoE/expert_load_cv", "Train/MoE/capacity_drop_fraction")
    steps = [s for _, s in held["records"] if "Train/Samples/train_loss" in s]
    if len(steps) != TELEMETRY_MOE_STEPS:
        fail(f"train-moe observability: {len(steps)} step records")
    E = MOE_BLOCK["num_experts"]
    rows = []
    for s in steps:
        if any(t not in s for t in tags):
            fail(f"a step record lacks {[t for t in tags if t not in s]}")
        lo, hi, cv, drop = (float(s[t]) for t in tags)
        if not (lo <= 1 / E <= hi and 0.0 <= drop < 1.0):
            fail(f"train-moe observability: min {lo}, max {hi}, drop {drop}")
        rows.append({"min": lo, "max": hi, "cv": cv, "drop": drop})
    tm["moe_stats"] = rows
    return tm


def env_and_dispatch(qm):
    """39(e): `python -m deeperspeed_tpu_torch.env_report --json` in its
    own process and `dispatch_report()` here, after (a)-(c): every
    SIGNATURES kernel available, and the designs "mma", "cluster" and
    "wgmma" (one bf16 int8 matmul call at a decode shape runs first: the
    last one of the full run is phase 38's fp32 parity, "fma")."""
    from deeperspeed_tpu_torch.ops import dispatch_report
    from deeperspeed_tpu_torch.ops.hopper import _build
    gen = torch.Generator(device="cuda").manual_seed(39)
    qw = qm.quantize_weight(torch.randn(768, 3072, device="cuda",
                                        generator=gen))
    qm.quant_matmul(torch.randn(16, 768, device="cuda", generator=gen,
                                dtype=torch.bfloat16), qw)
    proc = subprocess.run([sys.executable, "-m",
                           "deeperspeed_tpu_torch.env_report", "--json"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        fail(f"env_report --json exited {proc.returncode}: {proc.stderr}")
    rep = json.loads(proc.stdout)
    missing = [s for s in _build.SIGNATURES if not rep["ops"].get(s)]
    if missing:
        fail(f"env_report: kernels not available: {missing}")
    disp = dispatch_report()
    want = {"flash": ("fwd", "mma"), "decode_attention": ("decode",
                                                          "cluster"),
            "quant_matmul": ("quant_matmul", "wgmma")}
    for key, (k, v) in want.items():
        if disp[key].get(k) != v:
            fail(f"dispatch_report()[{key!r}] = {disp[key]}, want {k} {v}")
    return {"env": rep["env"], "kernels_available": len(_build.SIGNATURES),
            "dispatch": disp}


def run_observability_phases(fa, ad, gm, da, qm, report, card, sv=None):
    """Phase 39 → its result dict; ``sv`` is phase 4's serving result of
    this run (run beside when None)."""
    tmp = tempfile.mkdtemp(prefix="ds_telemetry_", dir="build")
    ledger = LaunchLedger(fa, ad)
    out = {"rungs": {}}
    for bs in TELEMETRY_RUNGS:
        print(f"train-telemetry-125M at micro {bs} (row_telemetry: telemetry "
              f"off, then on, capture off) on {card}:", flush=True)
        r = out["rungs"][bs] = telemetry_rung(ledger, bs, tmp)
        print(f"  step {r['telemetry_step_ms_off']:.2f} ms off, "
              f"{r['telemetry_step_ms_on']:.2f} ms on: overhead "
              f"{r['telemetry_overhead_pct']:+.2f}%; rounds' medians "
              f"{r['step_ms_median']['off']:.2f} / "
              f"{r['step_ms_median']['on']:.2f} ms: "
              f"{r['overhead_pct_median']:+.2f}% (bar "
              f"{TELEMETRY_BAR_PCT}%); in-engine MFU "
              f"{r['telemetry_mfu_in_engine']:.4f} (counted flops over "
              f"the stamped windows {r['telemetry_mfu_stamped_windows']:.4f})"
              f", analytic {r['telemetry_mfu_analytic']:.4f}, ratio "
              f"{r['telemetry_mfu_ratio']:.4f} (shapes "
              f"{r['telemetry_mfu_ratio_shapes']:.4f}, "
              f"{r['telemetry_mfu_ratio_off_pct']:+.2f}%, within "
              f"{TELEMETRY_MFU_TOL:.0%}: "
              f"{r['telemetry_mfu_ratio_within_prediction']}; shapes x "
              f"loop / windows "
              f"{r['telemetry_mfu_ratio_shapes_x_loop_over_windows']:.4f});"
              f" a step: window {r['step_window_ms']:.2f} ms, host "
              f"{r['host_ms_in_calls_outside_windows']:.2f} ms in the call "
              f"outside it, {r['host_ms_between_calls']:.3f} ms between "
              f"calls; goodput {r['telemetry_goodput_fraction']:.4f}; "
              f"syncs in {TELEMETRY_SYNC_STEPS} steps "
              f"{r['syncs_per_window']}; launches a step "
              f"{r['launches_per_step']} (kernels only with telemetry on: "
              f"{r['kernels_on_not_off']}); tensorboardX "
              f"{r['tensorboardX']}", flush=True)
    print(f"train-telemetry-16k (phase 13's engine, telemetry off, then on)"
          f" on {card}:", flush=True)
    lg = out["long_seq"] = telemetry_long_seq(fa, ad, tmp)
    print(f"  peak allocated above the engine's own: "
          f"{lg['off']['peak_above_held_bytes'] / 2 ** 30:.3f} GiB off, "
          f"{lg['on']['peak_above_held_bytes'] / 2 ** 30:.3f} GiB on "
          f"({lg['peak_rise_bytes'] / 2 ** 20:+.1f} MiB); first step "
          f"{lg['off']['steps_wall_s']:.2f} s off, "
          f"{lg['on']['steps_wall_s']:.2f} s on; counted flops "
          f"{lg['on']['flops']:.6g} (LUT width {lg['on']['lut_width']}); "
          f"mfu {lg['on']['mfu']}; hbm_peak_bytes "
          f"{lg['on']['hbm_peak_bytes']}", flush=True)
    print("train-telemetry-125M capture window and NaN episode:", flush=True)
    out["capture"] = telemetry_capture(ledger, tmp)
    c = out["capture"]
    print(f"  spans in the trace {c['spans_in_trace']}; kernels inside "
          f"train_dispatch {c['kernels_inside_dispatch']}; "
          f"{c['anomaly_captures']} anomaly capture, snapshot "
          f"{c['memory_snapshot']} ({c['memory_bytes_in_use']} bytes), "
          f"{c['windows_opened']} windows, traces {c['traces']}",
          flush=True)
    print(f"serve-telemetry-125M (phase 4's stream, telemetry, Prometheus) "
          f"on {card}:", flush=True)
    st = out["serve"] = serve_telemetry(fa, da, report, sv)
    o = st["observability"]
    print(f"  {st['tokens_per_s']:.1f} tokens/s (phase 4 "
          f"{(sv or report['serve_phase4_beside'])['tokens_per_s']:.1f}), "
          f"spans {o['spans']}, {len(o['serve_tags'])} Serve/* tags, "
          f"{o['scrape_ttft_count']}, same tokens as phase 4: "
          f"{st['same_tokens_as_phase4']}", flush=True)
    print(f"serve-125M, telemetry off and on in {SERVE_TELEMETRY_ROUNDS} "
          f"alternating rounds, on {card}:", flush=True)
    so = out["serve_rounds"] = serve_overhead(tmp)
    print(f"  tokens/s medians {so['tokens_per_s_median']['off']:.1f} off, "
          f"{so['tokens_per_s_median']['on']:.1f} on: overhead "
          f"{so['overhead_pct_median']:+.2f}% (rounds "
          f"{so['tokens_per_s_rounds']}); Serve/* scalars "
          f"{so['serve_scalars_us_a_step']:.1f} us a step, one span "
          f"{so['span_us']:.2f} us; {so['engine_steps_a_stream']} engine "
          f"steps a stream", flush=True)
    print(f"train-moe-125M with moe.observability ({TELEMETRY_MOE_STEPS} "
          f"steps) on {card}:", flush=True)
    tm = out["moe"] = train_moe_observability(fa, ad, gm, report, tmp)
    print(f"  step {tm['step_ms_median']:.1f} ms; Train/MoE/* a step: "
          f"{tm['moe_stats']}", flush=True)
    out["env"] = env_and_dispatch(qm)
    print(f"  env_report: {out['env']['kernels_available']} kernels "
          f"available on {out['env']['env']['device_name']}; dispatch "
          f"{out['env']['dispatch']}", flush=True)
    out["ledger"] = dict(ledger.totals)
    report["observability"] = out
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def obs_kernel_entries(ob):
    """What phase 39 adds to the kernels line: each kernel's launches on
    its paths."""
    st, tm, led = ob["serve"], ob["moe"], ob["ledger"]
    return {
        "flash_fwd": {"train_telemetry": led["flash_fwd"],
                      "serve_telemetry": st["launches"]["flash_fwd"],
                      "train_moe_obs": tm["launches"]["flash_fwd"]},
        "flash_bwd": {"train_telemetry": led["flash_bwd_dkv"],
                      "train_moe_obs": tm["launches"]["flash_bwd_dkv"]},
        "flash_bwd_dq": {"train_telemetry": led["flash_bwd_dq"],
                         "train_moe_obs": tm["launches"]["flash_bwd_dq"]},
        "adam": {"train_telemetry": led["adam"],
                 "train_moe_obs": tm["launches"]["adam"]},
        "grouped_matmul": {"train_moe_obs": tm["launches"][
            "grouped_matmul"]},
        "grouped_matmul_dw": {"train_moe_obs": tm["launches"][
            "grouped_matmul_dw"]},
        "paged_decode": {"serve_telemetry": st["launches"]["paged_decode"]},
    }


def merge_obs_entries(kernels, entries):
    """Add a phase's launches (phase 39's, phase 40's: ``entries``
    {kernel: {path: launches}}) to the kernels line's rows."""
    rows = {r["name"]: r for r in kernels}
    for name, paths in entries.items():
        if name == "flash_bwd_dq":
            continue
        row = rows[name]
        row["launches"] += sum(paths.values())
        row.setdefault("launches_by_path", {}).update(paths)
    if "flash_bwd" in rows:
        by_kernel = rows["flash_bwd"].setdefault("launches_by_kernel",
                                                 {"dkv": 0, "dq": 0})
        by_kernel["dkv"] += sum(entries["flash_bwd"].values())
        by_kernel["dq"] += sum(entries["flash_bwd_dq"].values())


def observability_only(card):
    """Phase 39 alone, after phase 3's training-shape flash and Adam
    checks and the grouped matmul's, with phase 7 beside (its step and
    MFU) and phase 4's stream run inside 39(c). The paged decode, which
    39(c) launches, is held and timed by the full run's phase 3."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (training shapes):", flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    gmm = check_grouped_matmul(gm, gen, report)
    print("training GPT-NeoX-125M (bf16, phase 7):", flush=True)
    tr = train(fa, ad, report)
    print_train("train-125M", tr, card)
    t39 = time.perf_counter()
    ob = run_observability_phases(fa, ad, gm, da, qm, report, card)
    report["phase39_seconds"] = time.perf_counter() - t39
    print(f"phase 39: {report['phase39_seconds']:.1f} s", flush=True)
    entries = obs_kernel_entries(ob)
    kernels = train_kernel_rows(ft, fb, adm, gmm, {
        "flash_fwd": {"train": tr["launches"]["flash_fwd"]},
        "flash_bwd": {"train": tr["launches"]["flash_bwd_dkv"]},
        "flash_bwd_dq": {"train": tr["launches"]["flash_bwd_dq"]},
        "adam": {"train": tr["launches"]["adam"]},
        "grouped_matmul": {}, "grouped_matmul_dw": {}})
    entries.pop("paged_decode")
    merge_obs_entries(kernels, entries)
    report["kernels"] = kernels
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_observability.json"),
              "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=str), flush=True)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 40: online RL (rl-ppo-125M, rl-ppo-gpt2xl)
# ---------------------------------------------------------------------------

# bench.py row_rl at GPT-NeoX-125M's full width: 16 rollouts an iteration
# in groups of 4 over a seeded pool of 16 prompts of 64 tokens, 64 new
# tokens each, one [16, 128] PPO-clip update on phase 7's optimizer,
# schedule, clipping, bf16 and ZeRO-2; the serving side pages of 16,
# decode buckets up to 16, temperature 1.0, seed 7
RL_SEQ = 128
RL_PROMPT_LEN = 64
RL_PROMPT_POOL = 16
RL_BLOCK = {"enabled": True, "loss": "ppo_clip",
            "rollouts_per_iteration": 16, "group_size": 4,
            "max_new_tokens": 64, "sequence_length": RL_SEQ}
RL_TRAIN_CONFIG = {**TRAIN_CONFIG, "train_batch_size": 16,
                   "train_micro_batch_size_per_gpu": 16,
                   "gradient_accumulation_steps": 1, "rl": RL_BLOCK}
RL_SERVE_CONFIG = {"inference": {
    "enabled": True, "page_size": 16, "num_pages": 257,
    "max_seq_len": RL_SEQ, "max_batch_size": 16, "token_budget": 2048,
    "prefill_lengths": [RL_PROMPT_LEN],
    "prefill_batch_sizes": [1, 2, 4, 8, 16],
    "decode_batch_sizes": [1, 2, 4, 8, 16], "temperature": 1.0,
    "seed": 7}}
RL_WARMUP = 1
# timed iterations of (a) rl-ppo-125M, (b) its int8 serving side, (c)
# DPO and (e) rl-ppo-gpt2xl
RL_ITERS = {"ppo": 4, "int8": 2, "dpo": 2, "gpt2xl": 2}
# (c): one chosen/rejected pair per group of 4 → 8 update rows
RL_DPO_TRAIN_CONFIG = {**RL_TRAIN_CONFIG, "train_batch_size": 8,
                       "train_micro_batch_size_per_gpu": 8,
                       "rl": {**RL_BLOCK, "loss": "dpo"}}
RL_DPO_LN2_TOL = 1e-2
# (f): the co-residency tax, bench.py row_rl's (6 steps; 2 warm-up steps
# before the RL pair exists, 1 with it resident) against its 10% bar
RL_TAX_STEPS = 6
RL_TAX_WARMUP = (2, 1)
RL_TAX_BAR_PCT = 10.0
# (d): kill and replay with a smaller stream, a checkpoint every iteration
RL_KILL_BLOCK = {**RL_BLOCK, "rollouts_per_iteration": 8,
                 "max_new_tokens": 32}
RL_KILL_ITERS, RL_KILL_AT = 3, 2
# (d)'s children at 2 of 125M's 12 layers (the full width): each child's
# checkpoints (masters and Adam state) are written and read at 91M
# parameters rather than 162M
RL_KILL_LAYERS = 2
# (g): fp32 parity at 4 layers, greedy, group size 1 (greedy rollouts of
# one prompt are identical, so a group of 4 would have no advantage),
# a constant learning rate (WarmupLR's first step has lr 0, which would
# leave iteration 2's policy equal to the reference); the losses within
# 1e-4 of each other (relative, at least 1e-4 absolute) and the mean KL
# within 1e-2 relative, of the same sign
RL_PARITY_LAYERS = 4
RL_PARITY_ITERS = 2
RL_PARITY_TOL = {"loss": 1e-4, "kl": 1e-2}
# the RL path's kernels checked at its own shapes before the rungs: the
# update's rows, the heads of GPT-NeoX-125M and GPT-2 XL, and the prefill
# batches of 1 and 16 prompts
RL_ROWS = RL_TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
RL_CHECK_HEADS = (NEOX_125M["num_heads"], GPT2_XL["num_heads"])
RL_CHECK_PREFILLS = (1, 16)


def rl_prompts(vocab, seed=0):
    """The seeded pool of 16 prompts of 64 ids."""
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=RL_PROMPT_LEN)))
            for _ in range(RL_PROMPT_POOL)]


def rl_reward(prompt, response):
    """A deterministic host function of the response: its share of even
    ids. (bench.py row_rl scores the distinct count, which saturates for
    samples over 50,304 ids: every reward of a group ties, PPO's
    advantages are 0 and DPO's chosen row is its rejected one.)"""
    return sum(t % 2 == 0 for t in response) / max(len(response), 1)


def reset_rl_counts(fa, da, qm, ad):
    torch.cuda.synchronize()
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.masked_launches = fa.masked_bwd_dkv_launches = 0
    fa.masked_bwd_dq_launches = 0
    fa.reset_flag_launches()
    fa.reset_design_launches()
    da.launches = da.launches_int8 = 0
    da.reset_launches_by_design()
    qm.launches = 0
    qm.reset_design_launches()
    ad.reset_launches()


def rl_counts(fa, da, qm, ad):
    torch.cuda.synchronize()
    return {"flash_fwd": fa.launches, "flash_bwd_dkv": fa.bwd_dkv_launches,
            "flash_bwd_dq": fa.bwd_dq_launches,
            "flash_masked_fwd": fa.masked_launches,
            "paged_decode": da.launches,
            "paged_decode_int8": da.launches_int8,
            "quant_matmul": qm.launches, "adam": ad.launches}


def rl_want(L, iters, prefill_calls, decode_steps, loss, int8):
    """The launches of ``iters`` iterations: per iteration L flash
    forwards for each training-side forward (the update's, the
    reference's and, for PPO, the behavior eval's), L dk/dv and L dq,
    one Adam; per serving prefill call L flash forwards; per decode step
    L paged decodes (the int8 kernel over int8 pages); with int8 weights
    4 int8 matmuls a block for every prefill call and decode step."""
    forwards = 3 if loss == "ppo_clip" else 2
    steps = prefill_calls + decode_steps
    return {"flash_fwd": L * (forwards * iters + prefill_calls),
            "flash_bwd_dkv": L * iters, "flash_bwd_dq": L * iters,
            "flash_masked_fwd": 0,
            "paged_decode": 0 if int8 else L * decode_steps,
            "paged_decode_int8": L * decode_steps if int8 else 0,
            "quant_matmul": 4 * L * steps if int8 else 0, "adam": iters}


def timed_updates(eng, sink, after=None):
    """Wrap ``eng.train_batch`` to record each update's milliseconds
    between two device syncs; ``after()`` runs past the timed span."""
    step = eng.train_batch

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **k)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after()
        return out
    eng.train_batch = timed


def serve_leaves(serve):
    from deeperspeed_tpu_torch.models.convert import _flatten
    return _flatten(serve.params, "", {})


def serve_holds(serve, natural):
    """True when the serving engine holds ``natural`` (a ``{name:
    tensor}`` of the trainer's dtype) as it prepares weights, bit for
    bit."""
    from deeperspeed_tpu_torch.module_inject.replace_module import \
        prepare_inference_params
    want = prepare_inference_params(natural, serve.compute_dtype)
    got = serve_leaves(serve)
    return set(got) == set(want) and all(
        torch.equal(got[n], want[n]) for n in want)


def guard_update(drv, state):
    """Run after each `train_batch` of ``drv`` (before its swap): record
    whether the serving engine still holds ``state["before"]`` (the
    pre-update weights) and whether the trainer's weights moved from
    them."""
    def check():
        before = state["before"]
        now = drv.engine.params_to_natural()
        state["held"].append(serve_holds(drv.serve, before))
        state["moved"].append(any(not torch.equal(now[n], before[n])
                                  for n in before))
    return check


def rl_iterations(drv, n, key, card, guard=None):
    """``n`` iterations of ``drv`` → their stats, each with the update's
    ms; with ``guard`` (`guard_update`'s state) the serving weights are
    checked between the update and the swap and after the swap (the
    checks' time is in ``iteration_s``)."""
    eng = drv.engine
    updates = []
    timed_updates(eng, updates,
                  None if guard is None else guard_update(drv, guard))
    rows = []
    for _ in range(n):
        if guard is not None:
            guard["before"] = eng.params_to_natural()
        t0 = time.perf_counter()
        out = dict(drv.run_iteration())
        out["iteration_s"] = time.perf_counter() - t0
        out["update_ms"] = updates[-1]
        if guard is not None:
            guard["after"].append(serve_holds(drv.serve,
                                              eng.params_to_natural()))
        rows.append(out)
        print(f"  {key} iteration {out['iteration']}: loss "
              f"{out['loss']:.6f}, mean reward {out['mean_reward']:.4f}, "
              f"mean KL {out['mean_kl']:.3e}, rollout "
              f"{out['rollout_tokens']} tokens in {out['rollout_s']:.3f} s "
              f"({out['rollout_tokens_per_s']:.1f} tokens/s), update "
              f"{out['update_ms']:.2f} ms, swap {out['swap_ms']:.3f} ms, "
              f"compile_delta {out['compile_delta']}, iteration "
              f"{out['iteration_s']:.3f} s on {card}", flush=True)
    del eng.train_batch
    return rows


def rl_rung(fa, da, qm, ad, key, eng, serve_config, iters, card,
            guard=False, int8=False):
    """One rung: the driver over ``eng``, the warm-up iteration, then
    ``iters`` timed iterations with every count set to 0 just before
    them and read just after: exact launches (every bf16 flash launch on
    the tensor-core design, every paged decode on the cluster kernel,
    every int8 matmul on wgmma), ``compile_delta`` 0, finite losses."""
    from deeperspeed_tpu_torch.rl import RLDriver
    model = eng.module
    L = model.config.num_layers
    drv = RLDriver(eng, rl_prompts(model.config.vocab_size), rl_reward,
                   serve_config)
    state = {"held": [], "moved": [], "after": []} if guard else None
    warm = rl_iterations(drv, RL_WARMUP, key, card, state)
    before = dict(drv.serve.program_calls)
    reset_rl_counts(fa, da, qm, ad)
    rows = rl_iterations(drv, iters, key, card, state)
    got = rl_counts(fa, da, qm, ad)
    prefill_calls = program_delta(drv.serve, before, "prefill")
    decode_steps = program_delta(drv.serve, before, "decode")
    want = rl_want(L, iters, prefill_calls, decode_steps, drv.loss_name,
                   int8)
    if got != want or not prefill_calls or not decode_steps:
        fail(f"{key}: launches {got} != {want} ({L} layers, {iters} "
             f"iterations, {prefill_calls} prefill calls, {decode_steps} "
             f"decode steps)")
    design = check_design(fa, key, {"fwd": got["flash_fwd"],
                                    "dkv": got["flash_bwd_dkv"],
                                    "dq": got["flash_bwd_dq"]})
    decode_design = check_decode_design(da, key, got, int8)
    qdesign = dict(qm.design_launches)
    if int8 and qdesign != {"wgmma": got["quant_matmul"], "fma": 0}:
        fail(f"{key}: int8 matmul launches by design {qdesign}, want all "
             f"{got['quant_matmul']} on wgmma")
    bad = [r["iteration"] for r in rows if r["compile_delta"]]
    if bad:
        fail(f"{key}: compile_delta != 0 on timed iterations {bad}")
    if not all(np.isfinite(r["loss"]) for r in warm + rows):
        fail(f"{key}: non-finite losses "
             f"{[r['loss'] for r in warm + rows]}")
    roll_s = sum(r["rollout_s"] for r in rows)
    out = {"warmup": warm, "iterations": rows, "launches": got,
           "design_launches": design, "decode_design_launches":
           decode_design, "prefill_calls": prefill_calls,
           "decode_steps": decode_steps,
           "rollout_tokens_per_s": sum(r["rollout_tokens"] for r in rows)
           / roll_s,
           "update_ms_median": float(np.median([r["update_ms"]
                                                for r in rows])),
           "swap_ms_median": float(np.median([r["swap_ms"] for r in rows])),
           "iteration_s_median": float(np.median([r["iteration_s"]
                                                  for r in rows])),
           "compile_delta": [r["compile_delta"] for r in rows],
           "adam_variants": dict(ad.variant_launches),
           "dtypes": drv.serve.dtypes}
    if int8:
        out["quant_matmul_design_launches"] = qdesign
    if state is not None:
        out["guard"] = {k: state[k] for k in ("held", "moved", "after")}
    return drv, out


def rl_engine(conf, model):
    import deeperspeed_tpu_torch as dst
    eng, *_ = dst.initialize(model=model, config_params=conf)
    return eng


def rl_lm_ms(eng, tokens, steps, warmup):
    """Milliseconds a plain LM step of ``eng`` over ``steps`` steps,
    between device syncs, after ``warmup`` steps."""
    for _ in range(warmup):
        eng.train_batch(batch=(tokens, tokens))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.train_batch(batch=(tokens, tokens))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def rl_ppo_125m(fa, da, qm, ad, card, out, profile_step=False):
    """(f)'s first half, (a) rl-ppo-125M with its checks (with
    ``profile_step``, one more iteration under torch.profiler), then
    (f)'s second half with (a)'s pair resident."""
    base_conf = {k: v for k, v in RL_TRAIN_CONFIG.items() if k != "rl"}
    base = rl_engine(base_conf, build_model(torch.bfloat16))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, NEOX_125M["vocab_size"], size=(1, 16, RL_SEQ))).cuda()
    pre_ms = rl_lm_ms(base, tokens, RL_TAX_STEPS, RL_TAX_WARMUP[0])
    print(f"rl-ppo-125M (a): PPO-clip, 16 rollouts of 64 + 64 tokens, "
          f"bf16, fp32 masters, ZeRO-2 on {card}:", flush=True)
    eng = rl_engine(RL_TRAIN_CONFIG, build_model(torch.bfloat16))
    init = eng.params_to_natural()
    drv, a = rl_rung(fa, da, qm, ad, "rl-ppo-125M", eng, RL_SERVE_CONFIG,
                     RL_ITERS["ppo"], card, guard=True)
    from deeperspeed_tpu_torch.models.convert import _flatten
    ref = _flatten(drv.buffer._ref_params, "", {})
    a["ref_bit_equal"] = set(ref) == set(init) and all(
        torch.equal(ref[n], init[n]) for n in init)
    if not a["ref_bit_equal"]:
        fail("rl-ppo-125M: the frozen reference moved from iteration 0's "
             "weights")
    g = a["guard"]
    if not (all(g["held"]) and all(g["after"]) and any(g["moved"])):
        fail(f"rl-ppo-125M: serving weights before the swaps {g['held']} "
             f"(want all pre-update), after {g['after']} (want all the "
             f"trainer's), trainer moved {g['moved']}")
    print(f"  reference bit-equal to iteration 0's: {a['ref_bit_equal']}; "
          f"serving weights pre-update until each swap: {g['held']}, the "
          f"trainer's after it: {g['after']}; launches {a['launches']}",
          flush=True)
    if profile_step:
        a["profile"] = profile_window(
            drv.run_iteration, 1, share_of="flash",
            also=("paged_decode", "adam", "gemm"))
        print_profile("rl-ppo-125M iteration (rollout, reference and "
                      "behavior forwards, update, swap)", a["profile"], card)
    co_ms = rl_lm_ms(base, tokens, RL_TAX_STEPS, RL_TAX_WARMUP[1])
    held_gb = torch.cuda.memory_allocated() / 2 ** 30
    tax = {"lm_step_ms_alone": pre_ms, "lm_step_ms_co_resident": co_ms,
           "tax_pct": (co_ms / pre_ms - 1) * 100,
           "bar_pct": RL_TAX_BAR_PCT, "memory_allocated_gb": held_gb}
    out["tax"] = tax
    print(f"rl co-residency tax (f): plain LM step [16, {RL_SEQ}] "
          f"{pre_ms:.3f} ms alone, {co_ms:.3f} ms with (a)'s pair resident "
          f"({held_gb:.2f} GiB allocated): {tax['tax_pct']:+.2f}% (JAX bar "
          f"{RL_TAX_BAR_PCT}%; a finding, not a check) on {card}",
          flush=True)
    del drv, eng, init, ref, base
    free_cuda()
    return a


def rl_int8_125m(fa, da, qm, ad, card, a):
    print(f"rl-ppo-125M-int8 (b): serving with int8 weights and int8 KV "
          f"pages on {card}:", flush=True)
    eng = rl_engine(RL_TRAIN_CONFIG, build_model(torch.bfloat16))
    _, b = rl_rung(fa, da, qm, ad, "rl-ppo-125M-int8", eng,
                   _quant_config(RL_SERVE_CONFIG, "int8", "int8"),
                   RL_ITERS["int8"], card, int8=True)
    print(f"  swap {b['swap_ms_median']:.3f} ms (re-quantizes; bf16 (a) "
          f"{a['swap_ms_median']:.3f} ms), rollout "
          f"{b['rollout_tokens_per_s']:.1f} tokens/s (a) "
          f"{a['rollout_tokens_per_s']:.1f}), dtypes {b['dtypes']}, "
          f"launches {b['launches']}", flush=True)
    del eng
    free_cuda()
    return b


def rl_dpo_125m(fa, da, qm, ad, card):
    print(f"rl-dpo-125M (c): DPO, group size 4, 8 update rows on {card}:",
          flush=True)
    eng = rl_engine(RL_DPO_TRAIN_CONFIG, build_model(torch.bfloat16))
    _, c = rl_rung(fa, da, qm, ad, "rl-dpo-125M", eng, RL_SERVE_CONFIG,
                   RL_ITERS["dpo"], card)
    first = c["warmup"][0]["loss"]
    c["first_loss"] = first
    c["first_loss_off_ln2"] = abs(first - float(np.log(2.0)))
    print(f"  first loss {first:.6f}: ln 2 {float(np.log(2.0)):.6f} "
          f"+- {RL_DPO_LN2_TOL}", flush=True)
    if c["first_loss_off_ln2"] > RL_DPO_LN2_TOL:
        fail(f"rl-dpo-125M: first loss {first} is not ln 2 within "
             f"{RL_DPO_LN2_TOL}")
    del eng
    free_cuda()
    return c


def rl_worker_spec():
    """(a)'s loop with the smaller stream and depth of (d), for
    `tests/torch_rl_worker.py`."""
    conf = {**RL_TRAIN_CONFIG, "train_batch_size": 8,
            "train_micro_batch_size_per_gpu": 8, "rl": RL_KILL_BLOCK}
    return {"device": "cuda",
            "model": {**NEOX_125M, "num_layers": RL_KILL_LAYERS},
            "dtype": "bfloat16", "seed": 0, "ds_config": conf,
            "serve_config": RL_SERVE_CONFIG,
            "prompts": {"n": RL_PROMPT_POOL, "len": RL_PROMPT_LEN,
                        "seed": 0}}


def rl_child(workdir, kill):
    """Start `tests/torch_rl_worker.py` on (d)'s spec in ``workdir``,
    killed in iteration ``kill`` (0: never)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_rl_worker.py"),
         workdir, "log.txt", str(RL_KILL_ITERS), str(kill),
         json.dumps(rl_worker_spec())], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def rl_wait(proc, timeout=600):
    """(return code, the child's timing lines, the end of its output);
    a child past ``timeout`` is killed."""
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    times = [ln[len("worker: "):] for ln in text.splitlines()
             if ln.startswith("worker: ")]
    return proc.returncode, times, text[-3000:]


def rl_read_log(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def rl_kill_replay(card):
    """(d): an uninterrupted child and a child killed (`os._exit` in the
    reward function) during iteration 2 run side by side; a third
    resumes the killed one. Iterations 1-3 must match bit for bit."""
    print(f"rl kill and replay (d): {RL_KILL_BLOCK['rollouts_per_iteration']}"
          f" rollouts of {RL_KILL_BLOCK['max_new_tokens']} new tokens at "
          f"{RL_KILL_LAYERS} layers, a "
          f"checkpoint every iteration, killed in iteration {RL_KILL_AT} "
          f"on {card}:", flush=True)
    tmp = tempfile.mkdtemp(prefix="ds_rl_kill_", dir="build")
    ref_dir, kill_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "kill")
    os.makedirs(ref_dir)
    os.makedirs(kill_dir)
    t0 = time.perf_counter()
    # the uninterrupted child runs beside the killed one and its resume
    ref_proc = rl_child(ref_dir, 0)
    procs = [ref_proc]
    try:
        kill_proc = rl_child(kill_dir, RL_KILL_AT)
        procs.append(kill_proc)
        rc_kill, t_kill, log_kill = rl_wait(kill_proc)
        if rc_kill != 9:
            fail(f"rl kill and replay: the killed child returned {rc_kill}"
                 f" (want 9): {log_kill}")
        killed = rl_read_log(os.path.join(kill_dir, "log.txt"))
        res_proc = rl_child(kill_dir, 0)
        procs.append(res_proc)
        rc_res, t_res, log_res = rl_wait(res_proc)
        rc_ref, t_ref, log_ref = rl_wait(ref_proc)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc_res != 0 or rc_ref != 0:
        fail(f"rl kill and replay: the resumed child returned {rc_res}, the "
             f"uninterrupted one {rc_ref} (want 0): {log_res} {log_ref}")
    wall = time.perf_counter() - t0
    print(f"  children: uninterrupted {t_ref}; killed {t_kill}; resumed "
          f"{t_res}", flush=True)
    ref = rl_read_log(os.path.join(ref_dir, "log.txt"))
    got = rl_read_log(os.path.join(kill_dir, "log.txt"))
    iters = list(range(1, RL_KILL_ITERS + 1))
    same = [g == r for g, r in zip(got, ref)]
    res = {"iterations_killed_child": [r["iteration"] for r in killed],
           "iterations": [r["iteration"] for r in got],
           "losses": [r["loss"] for r in got],
           "reference_losses": [r["loss"] for r in ref],
           "identical": same, "wall_s": wall,
           "child_seconds": {"uninterrupted": t_ref, "killed": t_kill,
                             "resumed": t_res}}
    print(f"  killed child logged {res['iterations_killed_child']}, the "
          f"resumed one went on to {res['iterations']}; losses "
          f"{res['losses']} vs uninterrupted {res['reference_losses']}; "
          f"losses and sampled tokens identical by iteration: {same}; "
          f"{wall:.1f} s", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    if [r["iteration"] for r in ref] != iters or \
            res["iterations"] != iters or \
            res["iterations_killed_child"] != iters[:RL_KILL_AT - 1] or \
            not all(same):
        fail(f"rl kill and replay: not bit-identical: {res}")
    return res


def rl_ppo_gpt2xl(fa, da, qm, ad, card):
    """(e): GPT-2 XL as the policy on the lean bf16 state, its server and
    its frozen reference co-resident."""
    from deeperspeed_tpu_torch import GPT2, GPT2Config
    print(f"rl-ppo-gpt2xl (e): GPT-2 XL ({GPT2_XL_PARAMS} parameters), the "
          f"lean bf16 state, (a)'s block on {card}:", flush=True)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg = GPT2Config.megatron_1_5b(param_dtype=torch.bfloat16)
    model = GPT2(cfg, device="cuda")
    conf = {**gpt2_conf(16, lean=True), "rl": RL_BLOCK}
    import deeperspeed_tpu_torch as dst
    eng, *_ = dst.initialize(model=model,
                             model_parameters=gpt2_tree(cfg, 0),
                             config_params=conf)
    if eng.num_params != GPT2_XL_PARAMS:
        fail(f"rl-ppo-gpt2xl: {eng.num_params} parameters, want "
             f"{GPT2_XL_PARAMS}")
    _, e = rl_rung(fa, da, qm, ad, "rl-ppo-gpt2xl", eng, RL_SERVE_CONFIG,
                   RL_ITERS["gpt2xl"], card)
    if e["adam_variants"] != {"lean": RL_ITERS["gpt2xl"]}:
        fail(f"rl-ppo-gpt2xl: Adam launches by variant "
             f"{e['adam_variants']}, want all lean")
    e["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  peak memory of the pair (trainer, server, reference) "
          f"{e['max_memory_allocated_gb']:.2f} GiB, swap "
          f"{e['swap_ms_median']:.3f} ms, update {e['update_ms_median']:.1f}"
          f" ms, rollout {e['rollout_tokens_per_s']:.1f} tokens/s, "
          f"compile_delta {e['compile_delta']} on {card}", flush=True)
    del eng, model
    free_cuda()
    return e


def rl_parity(card):
    """(g): (a)'s model at 4 layers in fp32, greedy, through the kernels
    and through the plain path (``use_kernels=False``, the serving
    engine's "xla" kernel choice)."""
    from deeperspeed_tpu_torch.rl import RLDriver
    conf = {k: v for k, v in RL_TRAIN_CONFIG.items()
            if k not in ("fp16", "scheduler", "rl")}
    conf["rl"] = {**RL_BLOCK, "group_size": 1}
    runs = {}
    for tag, kernels in (("kernels", True), ("plain", False)):
        model = build_model(torch.float32, num_layers=RL_PARITY_LAYERS)
        model.use_kernels = kernels
        serve = json.loads(json.dumps(RL_SERVE_CONFIG))
        serve["inference"]["temperature"] = 0.0
        if not kernels:
            serve["inference"]["kernel"] = "xla"
        seen = []

        def reward(prompt, response, seen=seen):
            seen.append(list(map(int, response)))
            return rl_reward(prompt, response)
        drv = RLDriver(rl_engine(conf, model),
                       rl_prompts(NEOX_125M["vocab_size"]), reward, serve)
        rows = drv.train(RL_PARITY_ITERS)
        runs[tag] = {"losses": [r["loss"] for r in rows],
                     "mean_kl": [r["mean_kl"] for r in rows],
                     "rollouts": seen}
        del drv, model
        free_cuda()
    k, p = runs["kernels"], runs["plain"]
    tol = RL_PARITY_TOL
    loss_ok = all(abs(a - b) <= tol["loss"] * max(1.0, abs(b))
                  for a, b in zip(k["losses"], p["losses"]))
    kl_ok = all(np.sign(a) == np.sign(b) and
                abs(a - b) <= tol["kl"] * abs(b) + 1e-9
                for a, b in zip(k["mean_kl"], p["mean_kl"]))
    same = k["rollouts"] == p["rollouts"]
    res = {"losses": {t: r["losses"] for t, r in runs.items()},
           "mean_kl": {t: r["mean_kl"] for t, r in runs.items()},
           "rollouts_identical": same, "tolerance": tol}
    print(f"  parity (g), fp32 at {RL_PARITY_LAYERS} layers, greedy: "
          f"rollouts identical {same}; losses {k['losses']} vs plain "
          f"{p['losses']}; mean KL {k['mean_kl']} vs {p['mean_kl']}",
          flush=True)
    if not (same and loss_ok and kl_ok and k["mean_kl"][-1] != 0.0):
        fail(f"rl parity: kernels vs plain differ: {res}")
    return res


def check_rl_kernels(fa, da, gen, report):
    """The bf16 kernels of rungs (a)-(e) against their plain versions at
    the RL path's own geometry, for heads 12 (GPT-NeoX-125M) and 25
    (GPT-2 XL), D 64: the training flash forward and backward at [16,
    128] causal (the update, the behavior and reference forwards), the
    serving prefill at 64 tokens (the prompts fill the bucket: one
    segment a row) for 1 and 16 prompts, and the paged decode at pages
    of 16, 8 pages a row, over bf16 and int8 pools; each launch on the
    design the rungs count (tensor-core flash, cluster decode), within
    TOL and TOL_BWD."""
    dtype = torch.bfloat16
    B, D = RL_ROWS, 64
    rows = []
    for H in RL_CHECK_HEADS:
        q, k, v, _, _ = prefill_case(RL_SEQ, dtype, gen, B=B, H=H, D=D)
        out, lse = fa.flash_attention_cuda(q, k, v)
        fwd_design = fa.LAST_DESIGN["fwd"]
        ref_out, ref_lse = fa.flash_attention_segmented_reference(q, k, v)
        err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
        err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
        grads, ok_g, _ = check_grads(fa, q, k, v, None, gen)
        row = {"kernel": "flash train", "B": B, "S": RL_SEQ, "H": H, "D": D,
               "max_abs_err_out": err_o, "max_abs_err_lse": err_l, **grads,
               "design": (fwd_design, fa.LAST_DESIGN["bwd"])}
        rows.append(row)
        print(f"  rl geometry {row}", flush=True)
        if not (ok_o and ok_l and ok_g and row["design"] == ("mma", "mma")):
            fail(f"flash kernels disagree with their plain versions (or "
                 f"left the tensor-core design) at the RL training shape: "
                 f"{row}")
        for n in RL_CHECK_PREFILLS:
            q, k, v, _, _ = prefill_case(RL_PROMPT_LEN, dtype, gen, B=n, H=H,
                                         D=D)
            seg = torch.ones(n, RL_PROMPT_LEN, dtype=torch.int32,
                             device="cuda")
            out, lse = fa.flash_attention_cuda(q, k, v, seg)
            design = fa.LAST_DESIGN["fwd"]
            ref_out, ref_lse = fa.flash_attention_segmented_reference(
                q, k, v, seg)
            err_o, ok_o = close(out, ref_out, *TOL[dtype]["out"])
            err_l, ok_l = close(lse, ref_lse, *TOL[dtype]["lse"])
            row = {"kernel": "flash prefill", "B": n, "S": RL_PROMPT_LEN,
                   "H": H, "D": D, "max_abs_err_out": err_o,
                   "max_abs_err_lse": err_l, "design": design}
            rows.append(row)
            print(f"  rl geometry {row}", flush=True)
            if not (ok_o and ok_l and design == "mma"):
                fail(f"flash prefill kernel disagrees with its plain version"
                     f" (or left the tensor-core design) at the RL prefill "
                     f"shape: {row}")
        shape = dict(B=B, H=H, D=D, ps=RL_SERVE_CONFIG["inference"][
            "page_size"], NP=RL_SEQ // RL_SERVE_CONFIG["inference"][
            "page_size"], P=RL_SERVE_CONFIG["inference"]["num_pages"])
        for int8 in (False, True):
            q, table, lengths = decode_query_case(dtype, gen, **shape)
            pools = decode_pools(gen, 2, shape["P"], H, shape["ps"], D,
                                 dtype, int8)
            views = tuple(p[1] for p in pools)
            out = decode_call(da, q, views, table, lengths)
            ref = decode_reference(da, q, views, table, lengths)
            err, ok = close(out, ref, *TOL[dtype]["out"])
            zero_ok = bool((out[lengths == 0] == 0).all())
            row = {"kernel": "paged_decode_int8" if int8 else
                   "paged_decode", **shape, "max_abs_err": err,
                   "design": da.kernel_design(q, views[0])}
            rows.append(row)
            print(f"  rl geometry {row}", flush=True)
            if not (ok and zero_ok and row["design"] == "cluster"):
                fail(f"paged decode kernel disagrees with its plain version"
                     f" (zero rows exact: {zero_ok}), or left the cluster "
                     f"kernel, at the RL decode shape: {row}")
            del pools, views
        torch.cuda.empty_cache()
    report["rl_kernel_checks"] = rows


def run_rl_phases(fa, da, qm, ad, report, card, profile_step=False):
    """Phase 40 → its result dict."""
    t0 = time.perf_counter()
    out = {}
    print(f"rl kernels vs plain versions at the RL path's shapes (bf16) on "
          f"{card}:", flush=True)
    check_rl_kernels(fa, da, torch.Generator(device="cuda").manual_seed(40),
                     report)
    out["ppo"] = rl_ppo_125m(fa, da, qm, ad, card, out, profile_step)
    out["int8"] = rl_int8_125m(fa, da, qm, ad, card, out["ppo"])
    out["dpo"] = rl_dpo_125m(fa, da, qm, ad, card)
    out["kill_replay"] = rl_kill_replay(card)
    out["gpt2xl"] = rl_ppo_gpt2xl(fa, da, qm, ad, card)
    print(f"rl parity (g): {RL_PARITY_ITERS} PPO iterations through the "
          f"kernels and the plain path on {card}:", flush=True)
    out["parity"] = rl_parity(card)
    out["seconds"] = time.perf_counter() - t0
    report["rl"] = out
    print(f"phase 40: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 41: data parallel and ZeRO 0-2 through a process group
# ---------------------------------------------------------------------------

DP_STEPS = 10
DP_STAGES = (0, 1, 2)
DP_WORLDS = (2, 4, 8)
# (d): two gloo ranks on the one card, micro 8 each (phase 7's global 16),
# 5 steps a stage (10 until phase 43 needed the room)
DP_CHILD_STAGES = (1, 2)
DP_CHILD_STEPS = 5
DP_CHILD_TIMEOUT = 300
# (d)'s losses against (a)'s: bf16 products at micro 8 round apart from
# those at micro 16, and the difference grows over the steps
TOL_DP_CHILD = 2e-2
# (b): the engine's buffers against memory_allocated: the model's
# non-parameter buffers and the allocator's rounding
TOL_DP_BYTES = 32 * 2 ** 20


class CollectiveClock:
    """CUDA events around each collective the engine issues in a run:
    the flat all-reduce (stage 0), the reduce-scatter and the all-gather
    (`runtime.zero.stage1`), and the mean loss's one-element
    all-reduce apart."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        def timed(*args, **kw):
            key = name
            if name == "all_reduce" and args[0].numel() == 1:
                key = "loss_all_reduce"
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.setdefault(key, []).append((start, end))
            return out
        return timed

    def ms(self, steps):
        """{name: {"calls", "median_call_ms", "median_step_ms"}}: a step's
        ms is the sum of its calls' (the median over the ``steps`` steps
        leaves out the first step's NCCL set-up)."""
        torch.cuda.synchronize()
        out = {}
        for k, v in self.events.items():
            times = np.array([s.elapsed_time(e) for s, e in v])
            out[k] = {"calls": len(times),
                      "median_call_ms": float(np.median(times)),
                      "median_step_ms": float(np.median(
                          times.reshape(steps, -1).sum(1)))}
        return out


def dp_collective_ms(n):
    """The collectives of (a) at world 1 on buffers of the model's size,
    each timed alone between CUDA events (`time_ms`), beside a plain
    device copy of the same bytes: the fp32 all-reduce (zero 0), the
    fp32 reduce-scatter (zero 1), the bf16 in-place all-gather (zero
    1-2)."""
    import torch.distributed as dist
    f32 = torch.randn(n, device="cuda")
    out32 = torch.empty(n, device="cuda")
    b16 = torch.randn(n, device="cuda").bfloat16()
    rows = {
        "all_reduce_fp32": time_ms(lambda: dist.all_reduce(f32)),
        "reduce_scatter_fp32": time_ms(
            lambda: dist.reduce_scatter_tensor(out32, f32)),
        "all_gather_bf16_in_place": time_ms(
            lambda: dist.all_gather_into_tensor(b16, b16)),
        "copy_fp32": time_ms(lambda: out32.copy_(f32)),
        "bytes_fp32": 4 * n}
    del f32, out32, b16
    torch.cuda.empty_cache()
    return rows


def dp_state_bytes(stage, n, world, part=None):
    """A rank's training-state bytes by the partition formula (bf16
    compute, fp32 masters): compute parameters and gradients, the fp32
    masters, the two fp32 moments, the fp32 accumulator (whole at stages
    0-1, the partition at 2) and stage 1's partition it is
    reduce-scattered into. ``n`` is padded to world x 8 from stage 1
    on."""
    from deeperspeed_tpu_torch.runtime.zero.stage1 import flat_partition
    if stage == 0:
        return {"params": 2 * n, "grads": 2 * n, "master": 4 * n,
                "exp_avg": 4 * n, "exp_avg_sq": 4 * n, "grad_acc": 4 * n}
    p = part or flat_partition(n, world, 0)
    out = {"params": 2 * p.padded, "grads": 2 * p.padded,
           "master": 4 * p.size, "exp_avg": 4 * p.size,
           "exp_avg_sq": 4 * p.size}
    if stage == 1:
        out.update(grad_acc=4 * p.padded, grad_part=4 * p.size)
    else:
        out["grad_acc"] = 4 * p.size
    return out


def dp_engine_bytes(eng):
    """The same buffers, read from the engine."""
    def nb(t):
        return t.numel() * t.element_size()
    out = {"params": nb(eng._params_flat), "grads": nb(eng._grads_flat),
           "master": nb(eng._master), "exp_avg": nb(eng.opt_state.exp_avg),
           "exp_avg_sq": nb(eng.opt_state.exp_avg_sq),
           "grad_acc": nb(eng._grad_acc)}
    if eng._grad_part is not None and eng._grad_part is not eng._grad_acc:
        out["grad_part"] = nb(eng._grad_part)
    return out


def dp_run(fa, ad, stage, tokens, clock=None):
    """One engine of phase 7's config at ``stage``, DP_STEPS steps: its
    losses, step ms, launches, state bytes (formula, buffers, allocated)
    and fp32 masters (on the card)."""
    import torch.distributed as dist

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.runtime import engine as engine_mod
    conf = {**TRAIN_CONFIG, "zero_optimization": {"stage": stage}}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(torch.float32)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    n = eng.num_params
    formula = dp_state_bytes(stage, n, eng.dp_world_size, eng._part)
    buffers = dp_engine_bytes(eng)
    if buffers != formula:
        fail(f"phase 41 (b): stage {stage} buffers {buffers} are not the "
             f"partition formula's {formula}")
    if abs(allocated - sum(formula.values())) > TOL_DP_BYTES:
        fail(f"phase 41 (b): stage {stage}: {allocated} bytes allocated "
             f"after the engine is built, the formula's "
             f"{sum(formula.values())}")
    saved = {}
    if clock is not None:
        saved = {"reduce_scatter_": engine_mod.reduce_scatter_,
                 "all_gather_": engine_mod.all_gather_}
        engine_mod.reduce_scatter_ = clock.wrap("reduce_scatter",
                                                saved["reduce_scatter_"])
        engine_mod.all_gather_ = clock.wrap("all_gather",
                                            saved["all_gather_"])
        saved["all_reduce"] = dist.all_reduce
        dist.all_reduce = clock.wrap("all_reduce", dist.all_reduce)
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    ad.launches = 0
    losses, step_s = [], []
    try:
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=(tokens, tokens)))
            step_s.append(time.perf_counter() - t0)
    finally:
        for name, fn in saved.items():
            if name == "all_reduce":
                dist.all_reduce = fn
            else:
                setattr(engine_mod, name, fn)
    launches = {"flash_fwd": fa.launches,
                "flash_bwd_dkv": fa.bwd_dkv_launches,
                "flash_bwd_dq": fa.bwd_dq_launches, "adam": ad.launches}
    gas, L = tokens.shape[0], model.config.num_layers
    want = {"flash_fwd": L * gas * DP_STEPS,
            "flash_bwd_dkv": L * gas * DP_STEPS,
            "flash_bwd_dq": L * gas * DP_STEPS, "adam": DP_STEPS}
    if launches != want:
        fail(f"phase 41 (a): stage {stage} launches {launches} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 41 (a): stage {stage} losses {losses}")
    master = eng._master.detach().clone()
    out = {"stage": stage, "dp_world_size": eng.dp_world_size,
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "step_ms_median": float(np.median(step_s)) * 1e3,
           "launches": launches, "num_params": n,
           "state_bytes": formula, "state_bytes_total":
           sum(formula.values()), "allocated_after_init": allocated}
    del eng, model
    torch.cuda.empty_cache()
    return out, master


def dp_adam_partitions(ad, gen, n):
    """(c): the flat Adam kernel on every partition of the world-N
    layouts and on one partition whose start is not 16-byte aligned,
    against the plain version on each slice and, all partitions
    together, the whole-buffer step bit for bit."""
    from deeperspeed_tpu_torch.runtime.zero.stage1 import flat_partition
    hp = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
    rows = []
    layouts = {f"world{w}": [(p.lo, p.hi) for p in (
        flat_partition(n, w, r) for r in range(w))] for w in DP_WORLDS}
    # a partition starting 3 elements in: 12 bytes into the fp32
    # buffers, 6 into the bf16 ones, so no pointer is 16-byte aligned
    layouts["unaligned"] = [(0, 3), (3, n // 2 + 1), (n // 2 + 1, n)]
    padded = max(hi for lay in layouts.values() for _, hi in lay)
    p = torch.randn(padded, generator=gen, device="cuda")
    g = torch.randn(padded, generator=gen, device="cuda").bfloat16()
    m = 0.1 * torch.randn(padded, generator=gen, device="cuda")
    v = 0.01 * torch.rand(padded, generator=gen, device="cuda")
    for name, layout in layouts.items():
        end = layout[-1][1]
        whole = [t[:end].clone() for t in (p, m, v)]
        whole_c = torch.empty(end, dtype=torch.bfloat16, device="cuda")
        ad.adam_cuda(*whole[:1], g[:end], *whole[1:], 6e-4, 3, adam_w=True,
                     bias_correction=True, p_out=whole_c, **hp)
        parts = [t[:end].clone() for t in (p, m, v)]
        parts_c = torch.empty(end, dtype=torch.bfloat16, device="cuda")
        err, ok, ms = 0.0, True, []
        for lo, hi in layout:
            ref = ad.adam_flat_reference(p[lo:hi], g[lo:hi], m[lo:hi],
                                         v[lo:hi], 6e-4, 3, **hp)
            args = [t[lo:hi] for t in parts]
            ad.adam_cuda(args[0], g[lo:hi], args[1], args[2], 6e-4, 3,
                         adam_w=True, bias_correction=True,
                         p_out=parts_c[lo:hi], **hp)
            for got, want in zip(args, ref):
                e, good = close(got, want, *TOL_ADAM)
                err, ok = max(err, e), ok and good
            if hi - lo > 1000:
                scratch = [t[lo:hi].clone() for t in (p, m, v)]
                ms.append(time_ms(lambda: ad.adam_cuda(
                    scratch[0], g[lo:hi], scratch[1], scratch[2], 6e-4, 3,
                    adam_w=True, bias_correction=True,
                    p_out=parts_c[lo:hi].clone(), **hp), warmup=2,
                    iters=10))
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(
            parts + [parts_c], whole + [whole_c]))
        starts = [lo for lo, _ in layout]
        row = {"layout": name, "partitions": len(layout), "end": end,
               "starts_16B_aligned": [(lo * 4) % 16 == 0 and (lo * 2) % 16
                                      == 0 for lo in starts],
               "max_abs_err": err, "tol": TOL_ADAM,
               "bit_equal_whole": bit_equal, "partition_ms": ms}
        print(f"  adam on partitions {row}", flush=True)
        if not (ok and bit_equal):
            fail(f"phase 41 (c): the Adam kernel on the {name} partitions "
                 f"disagrees: {row}")
        rows.append(row)
        del whole, whole_c, parts, parts_c
    if all(all(r["starts_16B_aligned"]) for r in rows):
        fail("phase 41 (c): no partition start was unaligned")
    del p, g, m, v
    torch.cuda.empty_cache()
    return rows


def dp_children(tmp, tokens, n_params):
    """(d): two ranks over gloo on the one card, `tests/torch_dp_worker.py`
    children at micro 8, ZeRO 1 then 2, DP_CHILD_STEPS steps each. Returns
    each rank's results."""
    import pickle
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    micro = tokens.shape[1] // 2
    conf = {**TRAIN_CONFIG, "train_batch_size": TRAIN_CONFIG[
        "train_batch_size"], "train_micro_batch_size_per_gpu": micro}
    cases = [{"kind": "train", "name": f"zero{stage}", "size": NEOX_125M,
              "seed": 0, "weights": None, "light": True,
              "conf": {**conf, "zero_optimization": {"stage": stage}},
              "tokens": tokens.cpu().numpy(), "steps": DP_CHILD_STEPS}
             for stage in DP_CHILD_STAGES]
    spec = os.path.join(tmp, "dp_spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "device": "cuda", "backend": "gloo",
                     "timeout": DP_CHILD_TIMEOUT}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                      if q])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(root, "tests",
                                          "torch_dp_worker.py"), spec, tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + DP_CHILD_TIMEOUT
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=max(
                1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 41 (d): a rank did not finish in {DP_CHILD_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode:
            fail(f"phase 41 (d): rank {rank} exited {proc.returncode}: "
                 f"{log[-3000:]}")
    out = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    for stage in DP_CHILD_STAGES:
        r0, r1 = (o[f"zero{stage}"] for o in out)
        if r0["losses"] != r1["losses"] or r0["dp_world_size"] != 2 or \
                r0["num_params"] != n_params:
            fail(f"phase 41 (d): zero {stage}: ranks disagree or the world "
                 f"is not 2: {r0['losses']} / {r1['losses']}")
    return out


def run_dp_phase(fa, ad, report, card, phase7_ms=None):
    """Phase 41 → its result dict. Sets up a world-1 NCCL process group
    and destroys it before returning, so later engines train without
    one."""
    import torch.distributed as dist

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.utils import distributed as ds_dist
    t0 = time.perf_counter()
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
    out = {"steps": DP_STEPS, "card": card}
    print(f"data parallel (a): phase 7's engine without a process group, "
          f"{DP_STEPS} steps:", flush=True)
    ref, ref_master = dp_run(fa, ad, 2, tokens)
    out["no_group"] = ref
    print(f"  losses {ref['losses']}, median step "
          f"{ref['step_ms_median']:.2f} ms on {card}", flush=True)
    if ds_dist.is_initialized():
        fail("phase 41: a process group exists before init_distributed")
    with socket_port() as port:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dst.init_distributed(dist_backend="nccl", timeout=300, verbose=False)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"phase 41: process group {dist.get_backend()} world "
                 f"{dist.get_world_size()}, want nccl world 1")
        for stage in DP_STAGES:
            clock = CollectiveClock()
            res, master = dp_run(fa, ad, stage, tokens, clock)
            res["collectives"] = clock.ms(DP_STEPS)
            res["bit_equal_no_group"] = {
                "losses": res["losses"] == ref["losses"],
                "masters": bool(torch.equal(master, ref_master))}
            print(f"  zero {stage} at world 1 over nccl: losses "
                  f"{res['losses']}, median step "
                  f"{res['step_ms_median']:.2f} ms (no group "
                  f"{ref['step_ms_median']:.2f}"
                  + (f", phase 7 {phase7_ms:.2f}" if phase7_ms else "")
                  + f"), collectives a step {res['collectives']}, launches "
                  f"{res['launches']}, bit-equal {res['bit_equal_no_group']}"
                  f" on {card}", flush=True)
            if not all(res["bit_equal_no_group"].values()):
                fail(f"phase 41 (a): zero {stage} at world 1 is not the "
                     f"engine without a group bit for bit: "
                     f"{res['bit_equal_no_group']}")
            out[f"zero{stage}"] = res
            del master
        out["collectives_alone"] = dp_collective_ms(ref["num_params"])
        print(f"  the collectives alone at world 1, n = "
              f"{ref['num_params']}: {out['collectives_alone']} (ms) on "
              f"{card}", flush=True)
    finally:
        dist.destroy_process_group()
    del ref_master
    torch.cuda.empty_cache()
    n = ref["num_params"]
    out["state_bytes_arithmetic"] = {
        f"world{w}": {f"zero{s}": sum(dp_state_bytes(s, n, w).values())
                      for s in DP_STAGES} for w in (1,) + DP_WORLDS}
    print(f"data parallel (b): a rank's state bytes at n = {n}, by the "
          f"partition formula (arithmetic, not measured above world 1): "
          f"{out['state_bytes_arithmetic']}; measured at world 1 "
          f"(memory_allocated after the engine is built): "
          f"{ {s: out[f'zero{s}']['allocated_after_init'] for s in DP_STAGES} }",
          flush=True)
    print("data parallel (c): the flat Adam kernel on partitions:",
          flush=True)
    out["adam_partitions"] = dp_adam_partitions(
        ad, torch.Generator(device="cuda").manual_seed(41), n)
    print("data parallel (d): two gloo ranks on this card, micro 8 each:",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="dp_children_", dir="build")
    try:
        kids = dp_children(tmp, tokens, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["two_ranks"] = {}
    for stage in DP_CHILD_STAGES:
        got = kids[0][f"zero{stage}"]["losses"]
        want = out[f"zero{stage}"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        step_ms = [max(a, b) for a, b in zip(
            kids[0][f"zero{stage}"]["step_ms"],
            kids[1][f"zero{stage}"]["step_ms"])]
        out["two_ranks"][f"zero{stage}"] = {
            "losses": got, "max_rel_diff_to_a": rel, "tol": TOL_DP_CHILD,
            "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "state_bytes": kids[0][f"zero{stage}"]["state_bytes"]}
        print(f"  zero {stage}: losses {got}, max relative difference to "
              f"(a) {rel:.3e}, median step (the slower rank's, the first "
              f"left out) {out['two_ranks'][f'zero{stage}']['step_ms_median']:.2f}"
              f" ms on {card}", flush=True)
        if not rel < TOL_DP_CHILD:
            fail(f"phase 41 (d): zero {stage} two-rank losses {got} are "
                 f"not within rtol {TOL_DP_CHILD} of (a)'s {want}")
    out["seconds"] = time.perf_counter() - t0
    report["dp"] = out
    print(f"phase 41: {out['seconds']:.1f} s", flush=True)
    return out


class socket_port:
    """A free TCP port on localhost (closed again on exit)."""

    def __enter__(self):
        import socket
        self._s = socket.socket()
        self._s.bind(("127.0.0.1", 0))
        return self._s.getsockname()[1]

    def __exit__(self, *exc):
        self._s.close()


def dp_kernel_entries(dp):
    """What phase 41 adds to the kernels line: each kernel's launches on
    its runs by path."""
    runs = {"train_dp_no_group": dp["no_group"]} | {
        f"train_dp_zero{s}": dp[f"zero{s}"] for s in DP_STAGES}
    return {name: {path: r["launches"][count] for path, r in runs.items()}
            for name, count in (("flash_fwd", "flash_fwd"),
                                ("flash_bwd", "flash_bwd_dkv"),
                                ("flash_bwd_dq", "flash_bwd_dq"),
                                ("adam", "adam"))}


def dp_only(card):
    """Phase 41 alone, after phase 3's training-shape flash and Adam
    checks."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (the training path's):", flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    dp = run_dp_phase(fa, ad, report, card)
    kernels = train_kernel_rows(ft, fb, adm, None, {
        "flash_fwd": {}, "flash_bwd": {}, "flash_bwd_dq": {}, "adam": {}})
    merge_obs_entries(kernels, dp_kernel_entries(dp))
    report["kernels"] = kernels
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_dp.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=str), flush=True)
    print(card, flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 42: ZeRO stage 3 (train-zero3-125M)
# ---------------------------------------------------------------------------

Z3_STEPS = 10
# the explicit schedule of (a), (c) and (d): bench.py's row_zero3 knobs
Z3_EXPLICIT = {"mode": "explicit", "prefetch_depth": 2, "bucket_mb": 32,
               "group_layers": 4}
Z3_RUNS = (("gspmd", {"mode": "gspmd"}),
           ("explicit", {**Z3_EXPLICIT, "remat": True}),
           ("explicit_no_remat", {**Z3_EXPLICIT, "remat": False}))
# (c): bench.py row_zero3's batch ladder at seq 1024, 6 steps after 2
# warm-up steps (the row's 12 after 4 until phase 43 needed the room),
# gas 1, Adam lr 1e-4
Z3_ROW_LADDER = (48, 32)
Z3_ROW_STEPS, Z3_ROW_WARMUP = 6, 2
# (d): two gloo ranks on the card, micro 8 each; a stage-3 step stages
# about 1.5 GB a rank through the host, so 3 steps a mode
Z3_CHILD_STEPS = 3
Z3_CHILD_TIMEOUT = 300
TOL_Z3_CHILD = 2e-2
# (b): 18 bytes a partition element (2 compute shard, 4 master, 8 moments,
# 4 accumulator) and 2 a persisted element, against memory_allocated
TOL_Z3_BYTES = 32 * 2 ** 20


class RowClock:
    """CUDA events around each stage-3 collective the runtime issues
    (`Zero3Runtime.gather_chunks`: all-gather a row, on the side stream;
    `scatter_chunks`: reduce-scatter a row's gradient), by row kind."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        def timed(rt, *args):
            row = args[-1]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(rt, *args)
            end.record()
            self.events.setdefault(f"{name}_{row.kind}", []).append(
                (start, end, row.padded))
            return out
        return timed

    def ms(self):
        """{collective_rowkind: {"calls", "median_ms", "row_elements"}}."""
        torch.cuda.synchronize()
        out = {}
        for k, v in self.events.items():
            times = [s.elapsed_time(e) for s, e, _ in v]
            out[k] = {"calls": len(times),
                      "median_ms": float(np.median(times)),
                      "row_elements": int(v[0][2])}
        return out


def z3_state_bytes(eng):
    """A stage-3 rank's state bytes by the formula, and by its buffers."""
    lay = eng._z3.layout
    formula = 18 * lay.part_size + 2 * lay.persisted_padded
    buffers = sum(t.numel() * t.element_size() for t in (
        eng._params_flat, eng._master, eng.opt_state.exp_avg,
        eng.opt_state.exp_avg_sq, eng._grad_acc, eng._z3.persist))
    return formula, buffers


def z3_profile(eng, tokens, card, name, steps=2):
    """Two more steps of ``eng`` under the profiler (`profile_window`),
    and the host ops that take the most self CPU time a step."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    res = profile_window(lambda: eng.train_batch(batch=(tokens, tokens)),
                         steps, also=("nccl", "elementwise", "Memcpy",
                                      "gemm", "flash"))
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            eng.train_batch(batch=(tokens, tokens))
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    res["top_host_ops"] = [
        {"name": e.key[:80], "self_cpu_ms_per_step":
         e.self_cpu_time_total / 1e3 / steps, "calls_per_step":
         e.count / steps} for e in top[:10]]
    print_profile(f"zero 3 profile, {name}", res, card)
    print(f"      device ms a step: nccl "
          f"{res['device_ms_per_step_nccl']:.3f}, elementwise "
          f"{res['device_ms_per_step_elementwise']:.3f}, memcpy "
          f"{res['device_ms_per_step_Memcpy']:.3f}, gemm "
          f"{res['device_ms_per_step_gemm']:.3f}, flash "
          f"{res['device_ms_per_step_flash']:.3f}", flush=True)
    for op in res["top_host_ops"][:8]:
        print(f"      host {op['self_cpu_ms_per_step']:.2f} ms "
              f"x{op['calls_per_step']:.0f}  {op['name']}", flush=True)
    return res


def z3_run(fa, ad, sched, tokens, clock=None, profile_step=False,
           card=None):
    """Phase 7's engine (TRAIN_CONFIG) at stage 3 with ``sched`` (None:
    the config's own stage, as phase 41's reference), Z3_STEPS steps:
    losses, step ms, launches, state bytes, peak memory over a step, and
    the masters in the natural order (on the card); with
    ``profile_step``, two more steps under the profiler."""
    from deeperspeed_tpu_torch.runtime.zero import stage3 as s3
    import deeperspeed_tpu_torch as dst
    conf = dict(TRAIN_CONFIG)
    if sched is not None:
        conf["zero_optimization"] = {"stage": 3, "schedule": sched}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(torch.float32)
    eng, *_ = dst.initialize(model=model, config_params=conf)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    out = {"schedule": sched, "allocated_after_init": allocated}
    if sched is not None:
        formula, buffers = z3_state_bytes(eng)
        out.update(state_bytes_formula=formula, state_bytes_buffers=buffers,
                   part_size=eng._z3.layout.part_size,
                   persisted=eng._z3.layout.persisted_numel)
        if buffers != formula:
            fail(f"phase 42 (b): {sched['mode']} buffers {buffers} bytes, "
                 f"the formula's {formula}")
        if abs(allocated - formula) > TOL_Z3_BYTES:
            fail(f"phase 42 (b): {sched}: {allocated} bytes allocated "
                 f"after the engine is built, the formula's {formula}")
    saved = {}
    if clock is not None:
        for name in ("gather_chunks", "scatter_chunks"):
            saved[name] = getattr(s3.Zero3Runtime, name)
            setattr(s3.Zero3Runtime, name, clock.wrap(
                "all_gather" if name == "gather_chunks" else
                "reduce_scatter", saved[name]))
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    ad.launches = 0
    losses, step_s, peak = [], [], None
    try:
        for i in range(Z3_STEPS):
            if i == Z3_STEPS - 1:
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=(tokens, tokens)))
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - before
    finally:
        for name, fn in saved.items():
            setattr(s3.Zero3Runtime, name, fn)
    gas, L = tokens.shape[0], model.config.num_layers
    remat = sched is not None and (sched["mode"] == "gspmd" or
                                   sched.get("remat", True))
    launches = {"flash_fwd": fa.launches, "flash_bwd_dkv":
                fa.bwd_dkv_launches, "flash_bwd_dq": fa.bwd_dq_launches,
                "adam": ad.launches}
    want = {"flash_fwd": (2 if remat else 1) * L * gas * Z3_STEPS,
            "flash_bwd_dkv": L * gas * Z3_STEPS,
            "flash_bwd_dq": L * gas * Z3_STEPS, "adam": Z3_STEPS}
    if launches != want:
        fail(f"phase 42 (a): {sched} launches {launches} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"phase 42 (a): {sched} losses {losses}")
    with torch.no_grad():
        master = eng._natural_flat(eng._master).clone()
    out.update(losses=losses, step_ms=[t * 1e3 for t in step_s],
               step_ms_median=float(np.median(step_s[1:])) * 1e3,
               launches=launches, num_params=eng.num_params,
               max_allocated_over_a_step=peak)
    if sched is not None:
        out["collectives"] = {"gathers": eng._z3.gathers,
                              "reduce_scatters": eng._z3.reduce_scatters}
    if profile_step:
        out["profile"] = z3_profile(eng, tokens, card, (sched or {}).get(
            "mode", "no group") + ("" if sched is None or sched.get(
                "remat", True) else " without remat"))
    del eng, model
    torch.cuda.empty_cache()
    return out, master


def z3_row_rung(bs, sched, card):
    """bench.py row_zero3 at batch ``bs`` (seq 1024, gas 1, lr 1e-4,
    bf16): tokens/s and MFU over Z3_ROW_STEPS steps after the warm-up;
    None where the batch does not fit on the card."""
    import deeperspeed_tpu_torch as dst
    zero = {"stage": 0} if sched is None else {"stage": 3,
                                               "schedule": sched}
    conf = {"train_batch_size": bs, "gradient_accumulation_steps": 1,
            "steps_per_print": 10_000,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
            "fp16": {"enabled": True, "type": "bfloat16"},
            "zero_optimization": zero}
    model = eng = tokens = None
    try:
        model = build_model(torch.float32)
        eng, *_ = dst.initialize(model=model, config_params=conf)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, NEOX_125M["vocab_size"], size=(1, bs, TRAIN_SEQ))).cuda()
        for _ in range(Z3_ROW_WARMUP):
            eng.train_batch(batch=(tokens, tokens))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Z3_ROW_STEPS):
            loss = eng.train_batch(batch=(tokens, tokens))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError:
        print(f"  batch {bs} does not fit ({sched}): the next rung",
              flush=True)
        return None
    finally:
        del eng, model, tokens
        gc.collect()
        torch.cuda.empty_cache()
    from deeperspeed_tpu_torch import GPTNeoXConfig
    cfg = GPTNeoXConfig(**NEOX_125M)
    tps = bs * TRAIN_SEQ * Z3_ROW_STEPS / dt
    flops_tok = 6 * cfg.num_params() + 12 * cfg.num_layers * \
        cfg.hidden_size * TRAIN_SEQ
    return {"batch": bs, "tokens_per_sec": tps,
            "mfu": tps * flops_tok / PEAK_FLOPS_S,
            "step_ms": dt / Z3_ROW_STEPS * 1e3, "last_loss": loss,
            "card": card}


def z3_children(tmp, tokens, n_params):
    """(d): two ranks over gloo on the one card, `tests/torch_dp_worker.py`
    children at micro 8, stage 3 "gspmd" then "explicit", Z3_CHILD_STEPS
    steps each. Returns each rank's results."""
    import pickle
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    micro = tokens.shape[1] // 2
    conf = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": micro}
    cases = [{"kind": "train", "name": name, "size": NEOX_125M, "seed": 0,
              "weights": None, "light": True,
              "conf": {**conf, "zero_optimization": {
                  "stage": 3, "schedule": sched}},
              "tokens": tokens.cpu().numpy(), "steps": Z3_CHILD_STEPS}
             for name, sched in Z3_RUNS[:2]]
    spec = os.path.join(tmp, "z3_spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "device": "cuda", "backend": "gloo",
                     "timeout": Z3_CHILD_TIMEOUT}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                      if q])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(root, "tests",
                                          "torch_dp_worker.py"), spec, tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + Z3_CHILD_TIMEOUT
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=max(
                1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 42 (d): a rank did not finish in {Z3_CHILD_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode:
            fail(f"phase 42 (d): rank {rank} exited {proc.returncode}: "
                 f"{log[-3000:]}")
    out = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    for name, _ in Z3_RUNS[:2]:
        r0, r1 = (o[name] for o in out)
        if r0["losses"] != r1["losses"] or r0["dp_world_size"] != 2 or \
                r0["num_params"] != n_params:
            fail(f"phase 42 (d): {name}: ranks disagree or the world is "
                 f"not 2: {r0['losses']} / {r1['losses']}")
        for rank, r in enumerate((r0, r1)):
            lay, sb = r["layout"], r["state_bytes"]
            formula = 18 * lay["part_size"] + 2 * lay["persisted_padded"]
            if sum(sb.values()) != formula:
                fail(f"phase 42 (d): {name} rank {rank} holds "
                     f"{sum(sb.values())} bytes at rest ({sb}), the "
                     f"formula at world 2 {formula}")
    return out


def run_zero3_phase(fa, ad, report, card, profile_step=False):
    """Phase 42 → its result dict. Sets up a world-1 NCCL process group
    for (a)-(c) and destroys it before (d) and before returning. With
    ``profile_step`` (``--zero3-only --profile``) each run of (a) takes
    two more steps under the profiler after its gates."""
    import torch.distributed as dist

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.utils import distributed as ds_dist
    t0 = time.perf_counter()
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, TRAIN_VOCAB_USED, size=(gas, micro, TRAIN_SEQ))).cuda()
    out = {"steps": Z3_STEPS, "card": card}
    print(f"zero 3 (a): phase 7's engine without a process group, "
          f"{Z3_STEPS} steps:", flush=True)
    ref, ref_master = z3_run(fa, ad, None, tokens,
                             profile_step=profile_step, card=card)
    out["no_group"] = ref
    print(f"  losses {ref['losses']}, median step "
          f"{ref['step_ms_median']:.2f} ms on {card}", flush=True)
    if ds_dist.is_initialized():
        fail("phase 42: a process group exists before init_distributed")
    with socket_port() as port:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dst.init_distributed(dist_backend="nccl", timeout=300, verbose=False)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"phase 42: process group {dist.get_backend()} world "
                 f"{dist.get_world_size()}, want nccl world 1")
        for name, sched in Z3_RUNS:
            clock = RowClock()
            res, master = z3_run(fa, ad, sched, tokens, clock,
                                 profile_step=profile_step, card=card)
            res["collective_ms"] = clock.ms()
            res["bit_equal_no_group"] = {
                "losses": res["losses"] == ref["losses"],
                "masters": bool(torch.equal(master, ref_master))}
            print(f"  zero 3 {name} at world 1 over nccl: losses "
                  f"{res['losses']}, median step "
                  f"{res['step_ms_median']:.2f} ms (no group "
                  f"{ref['step_ms_median']:.2f}), collectives (median "
                  f"call ms by row) {res['collective_ms']}, launches "
                  f"{res['launches']}, bit-equal "
                  f"{res['bit_equal_no_group']} on {card}", flush=True)
            print(f"  zero 3 {name} (b): state bytes at rest, formula "
                  f"{res['state_bytes_formula']} (18 x {res['part_size']} "
                  f"+ 2 x the persisted row), allocated after the build "
                  f"{res['allocated_after_init']}; max allocated over a "
                  f"step {res['max_allocated_over_a_step']} on {card}",
                  flush=True)
            if not all(res["bit_equal_no_group"].values()):
                fail(f"phase 42 (a): zero 3 {name} at world 1 is not the "
                     f"engine without a group bit for bit: "
                     f"{res['bit_equal_no_group']}")
            out[f"zero3_{name}"] = res
            del master
        print(f"zero 3 (c): bench.py row_zero3 at world 1, seq "
              f"{TRAIN_SEQ}, the first of batch {Z3_ROW_LADDER} that "
              f"fits, {Z3_ROW_STEPS} steps after {Z3_ROW_WARMUP}:",
              flush=True)
        out["row_zero3"] = {}
        for name, sched in (("zero0", None),
                            ("zero3", {"mode": "gspmd"}),
                            ("zero3_explicit", {**Z3_EXPLICIT,
                                                "remat": False})):
            row = None
            for bs in Z3_ROW_LADDER:
                row = z3_row_rung(bs, sched, card)
                if row is not None:
                    break
            if row is None or not np.isfinite(row["last_loss"]):
                fail(f"phase 42 (c): {name}: no rung of {Z3_ROW_LADDER} "
                     f"ran: {row}")
            out["row_zero3"][name] = row
            print(f"  {name}: {row}", flush=True)
    finally:
        dist.destroy_process_group()
    del ref_master
    torch.cuda.empty_cache()
    print("zero 3 (d): two gloo ranks on this card, micro 8 each, "
          f"{Z3_CHILD_STEPS} steps a mode:", flush=True)
    tmp = tempfile.mkdtemp(prefix="z3_children_", dir="build")
    try:
        kids = z3_children(tmp, tokens, ref["num_params"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["two_ranks"] = {}
    for name, _ in Z3_RUNS[:2]:
        got = kids[0][name]["losses"]
        want = out["zero3_gspmd"]["losses"][:Z3_CHILD_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        step_ms = [max(a, b) for a, b in zip(kids[0][name]["step_ms"],
                                             kids[1][name]["step_ms"])]
        out["two_ranks"][name] = {
            "losses": got, "max_rel_diff_to_a": rel, "tol": TOL_Z3_CHILD,
            "step_ms": step_ms,
            "state_bytes": [k[name]["state_bytes"] for k in kids]}
        print(f"  {name}: losses {got}, max relative difference to (a) "
              f"{rel:.3e}, step ms (the slower rank's) {step_ms}, a rank's "
              f"bytes at rest {out['two_ranks'][name]['state_bytes'][0]} "
              f"on {card}", flush=True)
        if not rel < TOL_Z3_CHILD:
            fail(f"phase 42 (d): {name} two-rank losses {got} are not "
                 f"within rtol {TOL_Z3_CHILD} of (a)'s {want}")
    out["seconds"] = time.perf_counter() - t0
    report["zero3"] = out
    print(f"phase 42: {out['seconds']:.1f} s", flush=True)
    return out


def zero3_kernel_entries(z3):
    """What phase 42 adds to the kernels line: each kernel's launches on
    its runs by path."""
    runs = {"train_zero3_no_group": z3["no_group"]} | {
        f"train_zero3_{name}": z3[f"zero3_{name}"] for name, _ in Z3_RUNS}
    return {name: {path: r["launches"][count] for path, r in runs.items()}
            for name, count in (("flash_fwd", "flash_fwd"),
                                ("flash_bwd", "flash_bwd_dkv"),
                                ("flash_bwd_dq", "flash_bwd_dq"),
                                ("adam", "adam"))}


def zero3_only(card, profile_step=False):
    """Phase 42 alone, after phase 3's training-shape flash and Adam
    checks (with ``profile_step``, each run of (a) profiled)."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (the training path's):", flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    z3 = run_zero3_phase(fa, ad, report, card, profile_step)
    kernels = train_kernel_rows(ft, fb, adm, None, {
        "flash_fwd": {}, "flash_bwd": {}, "flash_bwd_dq": {}, "adam": {}})
    merge_obs_entries(kernels, zero3_kernel_entries(z3))
    report["kernels"] = kernels
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_zero3.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=str), flush=True)
    print(card, flush=True)
    return 0


RL_PATHS = {"ppo": "rl_ppo_125m", "int8": "rl_ppo_125m_int8",
            "dpo": "rl_dpo_125m", "gpt2xl": "rl_ppo_gpt2xl"}


def rl_kernel_entries(rl):
    """What phase 40 adds to the kernels line: each kernel's launches on
    its rungs by path."""
    entries = {}
    for name, count in (("flash_fwd", "flash_fwd"),
                        ("flash_bwd", "flash_bwd_dkv"),
                        ("flash_bwd_dq", "flash_bwd_dq"), ("adam", "adam"),
                        ("paged_decode", "paged_decode"),
                        ("paged_decode_int8", "paged_decode_int8"),
                        ("quant_matmul", "quant_matmul")):
        paths = {path: rl[rung]["launches"][count]
                 for rung, path in RL_PATHS.items()
                 if rl[rung]["launches"][count]}
        entries[name] = paths
    return entries


def rl_only(card, profile_step=False):
    """Phase 40 alone, after phase 3's training-shape flash and Adam
    checks, the paged decode over bf16 and int8 pools and the int8
    matmul: the kernels its rungs launch."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (the RL path's):", flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    de, _ = check_decode(da, report)
    di, _ = check_decode(da, report, int8=True)
    qrows = check_quant_matmul(qm, gen, report)
    rl = run_rl_phases(fa, da, qm, ad, report, card, profile_step)
    kernels = rl_kernel_rows(ft, fb, adm, de, di, qrows[0],
                             rl_kernel_entries(rl))
    report["kernels"] = kernels
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_rl.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=str), flush=True)
    print(card, flush=True)
    return 0


def rl_kernel_rows(ft, fb, adm, de, di, q0, entries):
    """The kernels line of ``--rl-only``: phase 3's numbers (flash and
    Adam at the training shape, the paged decode over bf16 and int8 pools
    at phase 3's shape, the int8 matmul at M = 16) and the launches of
    phase 40's rungs."""
    pallas = "deeperspeed_tpu/ops/pallas/"
    rows = train_kernel_rows(ft, fb, adm, None, {
        "flash_fwd": {}, "flash_bwd": {}, "flash_bwd_dq": {}, "adam": {},
        "grouped_matmul": {}, "grouped_matmul_dw": {}})
    rows += [
        {"name": "paged_decode", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:84 (_decode_kernel)",
         "launches": 0, **_row_nums(de, de["max_abs_err"]),
         "library": de["library"], "shape": f"{de['shape']} bf16"},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:152 "
                     f"(_decode_kernel_quant)",
         "launches": 0, **_row_nums(di, di["max_abs_err"]),
         "library": di["library"],
         "shape": f"{di['shape']} int8 pools, bf16 scales"},
        {"name": "quant_matmul", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/quant_matmul.cu",
         "replaces": f"{pallas}quant_matmul.py:152 (_wq_kernel)",
         "launches": 0, **_row_nums(q0, q0["max_abs_err"]),
         "shape": f"M={q0['M']} K={q0['K']} N={q0['N']} bf16"}]
    merge_obs_entries(rows, entries)
    return rows


# ---------------------------------------------------------------------------
# phase 43: MoE across ranks (train-moe-ep-125M)
# ---------------------------------------------------------------------------

# phase 11's model and JSON at ZeRO stage 0: the experts of an "expert"
# mesh train at stage 0, as the JAX engine's do (stages 1-3 map the axis
# twice there)
MOE_EP_CONFIG = {**MOE_TRAIN_CONFIG, "zero_optimization": {"stage": 0}}
MOE_EP_STEPS = 10
# (c): two gloo ranks on this card, micro 4 each (the global batch is
# (a)'s), 3 steps a run
MOE_EP_CHILD_STEPS = 3
MOE_EP_CHILD_TIMEOUT = 300
# the losses' relative difference to (a)'s (sound runs: 8.3e-6), and the
# fp32 masters' gap to (a)'s over (a)'s update, experts and dense apart
# (`master_gap`)
TOL_MOE_EP_CHILD = 1e-3
TOL_MOE_EP_MASTER = 0.5
# (d): an owner's received buffer at ep 2: its 4 experts, 2 spans of
# GMM_SPAN rows each (one a source rank), ragged: partial spans, a full
# one, and an expert no rank sent a row (its dW exact zeros)
MOE_EP_LUT_SIZES = (1400, 1160, 977, 1583, 2560, 0, 0, 0)


class A2ARecorder:
    """The shape and dtype of every all-to-all of the MoE exchange
    (`utils.distributed._all_to_all`) while on; each runs as the path
    issues it (asynchronously where the path asks)."""

    def __init__(self, ds_dist):
        self.ds_dist, self.calls, self.group = ds_dist, [], None
        self._orig = ds_dist._all_to_all

    def __enter__(self):
        orig = self._orig

        def recorded(x, group, async_op=False):
            self.calls.append((tuple(x.shape), x.dtype))
            self.group = group
            return orig(x, group, async_op=async_op)
        self.ds_dist._all_to_all = recorded
        return self

    def __exit__(self, *exc):
        self.ds_dist._all_to_all = self._orig


def a2a_device_ms(ds_dist, rec, steps, iters=10, spin_ms=2.0):
    """The device time of each distinct all-to-all ``rec`` saw (shape,
    dtype), on its group: each of ``iters`` calls (after 2 untimed) is
    issued behind a spin kernel (`torch.cuda._sleep`) of about
    ``spin_ms``, so the stream is busy while the host enqueues the
    collective and the CUDA events around it time the device's work, not
    the host's; the host's enqueue is timed beside it on the host clock.
    → {"calls_per_step", "by_shape": {shape dtype: {"calls", "bytes",
    "device_ms_median", "host_enqueue_ms_median"}}, "device_ms_per_step"
    (a step's calls at their medians), "spin_ms", "host_hidden" (every
    enqueue shorter than the spin)}."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(10 ** 7)
    e1.record()
    torch.cuda.synchronize()
    spin = int(10 ** 7 * spin_ms / e0.elapsed_time(e1))
    counts = {}
    for call in rec.calls:
        counts[call] = counts.get(call, 0) + 1
    by, per_step, host_max = {}, 0.0, 0.0
    for (shape, dtype), n in counts.items():
        x = torch.randn(shape, device="cuda").to(dtype)
        dev, host = [], []
        for i in range(iters + 2):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.perf_counter()
            ds_dist._all_to_all(x, rec.group)
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                dev.append(start.elapsed_time(end))
                host.append((t1 - t0) * 1e3)
        med = float(np.median(dev))
        by[f"{list(shape)} {str(dtype)[6:]}"] = {
            "calls": n, "bytes": x.numel() * x.element_size(),
            "device_ms_median": med,
            "host_enqueue_ms_median": float(np.median(host))}
        per_step += med * n / steps
        host_max = max(host_max, max(host))
        del x
    return {"calls_per_step": len(rec.calls) / steps, "by_shape": by,
            "device_ms_per_step": per_step, "spin_ms": spin_ms,
            "host_hidden": host_max < spin_ms}


def master_gap(got, want, init, expert_ranges):
    """How far the fp32 masters ``got`` are from ``want`` (both whole, in
    the natural order, trained from ``init``), by part ("experts": the
    ``expert_ranges`` of the flat; "dense": the rest) → {part: {"rel":
    ‖got − want‖ / ‖want − init‖ (the gap over the training's update),
    "max_abs"}}."""
    experts = torch.zeros(want.numel(), dtype=torch.bool, device=want.device)
    for lo, hi in expert_ranges:
        experts[lo:hi] = True
    out = {}
    for part, m in (("experts", experts), ("dense", ~experts)):
        d, u = got[m] - want[m], want[m] - init[m]
        out[part] = {"rel": float(d.norm() / u.norm()),
                     "max_abs": float(d.abs().max())}
        del d, u
    return out


def moe_ep_run(fa, ad, gm, tokens, mesh=None, steps=MOE_EP_STEPS,
               snap_at=None):
    """(a): phase 11's model and JSON at stage 0 on this card, with
    ``mesh`` (a 1-D "expert" `DeviceMesh` over a world-1 NCCL group) or
    without a group, ``steps`` steps → (result, fp32 masters, snaps):
    with ``snap_at``, snaps holds the whole fp32 masters in the natural
    order before training ("init") and after ``snap_at`` steps ("snap"),
    and the natural flat's expert leaves ("expert_ranges"). Exact
    launches: phase 11's (two grouped forward and two dx products a
    layer on the wgmma design, two dW), flash and one Adam a step."""
    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models.gpt_neox import is_expert_leaf
    model = build_model(torch.float32)
    eng, *_ = dst.initialize(model=model, config_params=MOE_EP_CONFIG,
                             mesh=mesh)
    if eng.num_params != MOE_NUM_PARAMS or \
            (mesh is not None and not (eng.expert_mesh and eng.ep == 1)):
        fail(f"phase 43 (a): the engine on {mesh} holds {eng.num_params} "
             f"parameters, expert mesh {eng.expert_mesh}, ep {eng.ep}")
    L = model.config.num_layers
    torch.cuda.synchronize()
    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    fa.reset_design_launches()
    ad.launches = 0
    gm.launches = gm.dw_launches = 0
    gm.reset_design_launches()
    snaps = {}
    if snap_at:
        snaps["init"] = eng._natural_flat(eng._master).detach().clone()
        snaps["expert_ranges"] = [(lo, hi) for n, lo, hi, _ in
                                  eng.natural_slices if is_expert_leaf(n)]
    losses, step_s = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(eng.train_batch(batch=(tokens, tokens)))
        step_s.append(time.perf_counter() - t0)
        if step + 1 == snap_at:
            snaps["snap"] = eng._natural_flat(eng._master).detach().clone()
    launches = {"flash_fwd": fa.launches,
                "flash_bwd_dkv": fa.bwd_dkv_launches,
                "flash_bwd_dq": fa.bwd_dq_launches, "adam": ad.launches,
                "grouped_matmul": gm.launches,
                "grouped_matmul_dw": gm.dw_launches}
    want = {"flash_fwd": L * steps, "flash_bwd_dkv": L * steps,
            "flash_bwd_dq": L * steps, "adam": steps,
            "grouped_matmul": 4 * L * steps,
            "grouped_matmul_dw": 2 * L * steps}
    design = {"grouped_matmul": dict(gm.design_launches),
              "grouped_matmul_dw": dict(gm.dw_design_launches)}
    if launches != want or not all(np.isfinite(losses)):
        fail(f"phase 43 (a): launches {launches} != {want}, or losses "
             f"{losses} not finite")
    for name in design:
        if design[name] != {"wgmma": launches[name], "fma": 0}:
            fail(f"phase 43 (a): {name} launches by design {design[name]}, "
                 f"want all {launches[name]} on wgmma")
    master = eng._master.detach().clone()
    res = {"losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "step_ms_median": float(np.median(step_s)) * 1e3,
           "launches": launches, "design_launches": design,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "num_params": eng.num_params}
    del eng, model
    torch.cuda.empty_cache()
    return res, master, snaps


def moe_ep_layer_bits(report):
    """(b): `moe_ffn_expert_parallel` at ep 1 (the world-1 group) against
    `moe_ffn_dense` at phase 11's layer geometry (8192 tokens, H 768,
    I 3072, 8 experts, top 2, capacity factor 1.25, bf16): both engines,
    the sort engine's exchange in 1 and 2 chunks; outputs and aux bit for
    bit (gated), the gradients' identity printed."""
    import torch.distributed as dist

    from deeperspeed_tpu_torch.moe import layer as ml
    H, I, E, T = 768, 3072, 8, MOE_TRAIN_CONFIG[
        "train_micro_batch_size_per_gpu"] * TRAIN_SEQ
    layer = ml.MoELayer(H, I, E, device="cuda", param_dtype=torch.bfloat16)
    params = layer.init(0)
    x = torch.randn(T, H, generator=torch.Generator(device="cuda")
                    .manual_seed(3), device="cuda").to(torch.bfloat16)
    kw = dict(capacity_factor=MOE_BLOCK["capacity_factor"],
              top_k=MOE_BLOCK["top_k"])
    out = {}

    def run(fn, **extra):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        y, aux = fn(p, xx, **kw, **extra)
        (y.float().square().mean() + aux).backward()
        return y.detach(), aux.detach(), xx.grad, {k: v.grad for k, v in
                                                  p.items()}
    for dispatch in ("einsum", "sort"):
        dense = run(ml.moe_ffn_dense, dispatch=dispatch)
        for chunks in ((1, 2) if dispatch == "sort" else (1,)):
            ep = run(lambda p, xx, **k: ml.moe_ffn_expert_parallel(
                p, xx, dist.group.WORLD, 1, **k), dispatch=dispatch,
                a2a_overlap_chunks=chunks)
            fwd = bool(torch.equal(ep[0], dense[0]) and
                       torch.equal(ep[1], dense[1]))
            bwd = bool(torch.equal(ep[2], dense[2]) and all(
                torch.equal(ep[3][k], dense[3][k]) for k in dense[3]))
            out[f"{dispatch}_chunks{chunks}"] = {"forward_bit_equal": fwd,
                                                 "grads_bit_equal": bwd}
            print(f"  (b) moe_ffn_expert_parallel ep 1, {dispatch}, "
                  f"{chunks} chunk(s) vs moe_ffn_dense: y and aux bit-equal "
                  f"{fwd}, gradients bit-equal {bwd}", flush=True)
            if not fwd:
                fail(f"phase 43 (b): {dispatch} with {chunks} chunk(s) is "
                     f"not moe_ffn_dense bit for bit")
    report["moe_ep_layer_bits"] = out
    return out


def moe_ep_children(tmp, tokens, n_params):
    """(c): two ranks over gloo on this card (`tests/torch_dp_worker.py`
    children, micro 4 each): the "expert" mesh (4 experts a rank) and the
    data-parallel path with replicated experts routing the global
    micro-batch, MOE_EP_CHILD_STEPS steps each; rank 0 saves each run's
    whole fp32 masters to ``tmp``/{name}_master.pt. → each rank's
    results."""
    import pickle
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    conf = {**MOE_EP_CONFIG, "train_micro_batch_size_per_gpu":
            tokens.shape[1] // 2}
    cases = [{"kind": "train", "name": name, "size": NEOX_125M, "seed": 0,
              "weights": None, "light": True, "conf": conf,
              "tokens": tokens.cpu().numpy(), "steps": MOE_EP_CHILD_STEPS,
              "mesh": mesh,
              "master_file": os.path.join(tmp, f"{name}_master.pt")}
             for name, mesh in (("ep2", "expert"), ("dp2", None))]
    spec = os.path.join(tmp, "moe_ep_spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "device": "cuda", "backend": "gloo",
                     "timeout": MOE_EP_CHILD_TIMEOUT}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                      if q])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(root, "tests",
                                          "torch_dp_worker.py"), spec, tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + MOE_EP_CHILD_TIMEOUT
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=max(
                1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 43 (c): a rank did not finish in "
             f"{MOE_EP_CHILD_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode:
            fail(f"phase 43 (c): rank {rank} exited {proc.returncode}: "
                 f"{log[-3000:]}")
    out = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    for name, want_ep, want_n in (("ep2", 2, None), ("dp2", 1, n_params)):
        r0, r1 = (o[name] for o in out)
        if r0["losses"] != r1["losses"] or r0["dp_world_size"] != 2 or \
                r0["ep"] != want_ep or (want_n is not None and
                                        r0["num_params"] != want_n):
            fail(f"phase 43 (c): {name}: ranks disagree or the layout is "
                 f"not the expected one: {r0['losses']} / {r1['losses']}, "
                 f"ep {r0['ep']}, {r0['num_params']} parameters")
    return out


def moe_ep_lut_case(gm, gen, report):
    """(d): the grouped matmul on an owner's received buffer at ep 2
    (MOE_EP_LUT_SIZES: 4 experts of 2 ragged spans each, LUT (0, 0, 1,
    1, 2, 2, 3, 3)) at both FFN products in bf16: forward, dx and dW
    against `grouped_matmul_reference` (`gmm_case`: dead rows and the
    empty expert's dW exact zeros), two calls of each bit-identical; the
    forward at (768, 3072) timed beside its plain version and torch.bmm
    over the padded buffer."""
    W = 4
    lut = tuple(np.repeat(np.arange(W), 2).tolist())
    rows = []
    for K, N in GMM_SHAPES:
        row, (x, w, dy, sz) = gmm_case(gm, gen, MOE_EP_LUT_SIZES, GMM_SPAN,
                                       K, N, W, lut, torch.bfloat16)
        same = bool(
            torch.equal(gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN, lut),
                        gm.grouped_matmul_cuda(x, w, sz, GMM_SPAN, lut)) and
            torch.equal(gm.grouped_matmul_cuda(dy, w, sz, GMM_SPAN, lut,
                                               transpose_w=True),
                        gm.grouped_matmul_cuda(dy, w, sz, GMM_SPAN, lut,
                                               transpose_w=True)) and
            torch.equal(gm.grouped_matmul_dw_cuda(x, dy, sz, GMM_SPAN, lut,
                                                  W),
                        gm.grouped_matmul_dw_cuda(x, dy, sz, GMM_SPAN, lut,
                                                  W)))
        row["bit_identical"] = same
        if not same:
            fail(f"phase 43 (d): two calls differ on the expert-parallel "
                 f"LUT: {row}")
        if (K, N) == GMM_SHAPES[0]:
            xb = x.view(W, 2 * GMM_SPAN, K)
            row["ms"] = time_ms(lambda: gm.grouped_matmul_cuda(
                x, w, sz, GMM_SPAN, lut))
            row["plain_ms"] = time_ms(lambda: gm.grouped_matmul_reference(
                x, w, sz, GMM_SPAN, lut), warmup=2, iters=10)
            row["library_ms"] = time_ms(lambda: torch.bmm(xb, w))
            live = sum(MOE_EP_LUT_SIZES)
            esz = x.element_size()
            row["bound_ms"], row["bound_by"] = bound_ms(
                live * K * esz + W * K * N * esz + x.shape[0] * N * esz,
                2 * live * K * N)
            print(f"  (d) forward on the ep-2 LUT: {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, torch.bmm "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} "
                  f"ms ({row['bound_by']})", flush=True)
        rows.append(row)
        del x, w, dy, sz
    torch.cuda.empty_cache()
    report["moe_ep_lut"] = rows
    return rows


def run_moe_ep_phase(fa, ad, gm, report, card, phase11_ms=None):
    """Phase 43 → its result dict. A world-1 NCCL process group for
    (a) and (b), destroyed before (c)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.utils import distributed as ds_dist
    t0 = time.perf_counter()
    micro = MOE_TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, TRAIN_VOCAB_USED, size=(1, micro, TRAIN_SEQ))).cuda()
    out = {"steps": MOE_EP_STEPS, "card": card}
    print(f"moe ep (a): phase 11's engine at stage 0 without a process "
          f"group, {MOE_EP_STEPS} steps:", flush=True)
    ref, ref_master, snaps = moe_ep_run(fa, ad, gm, tokens,
                                        snap_at=MOE_EP_CHILD_STEPS)
    out["no_group"] = ref
    if ds_dist.is_initialized():
        fail("phase 43: a process group exists before init_distributed")
    with socket_port() as port:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dst.init_distributed(dist_backend="nccl", timeout=300, verbose=False)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("expert",))
        with A2ARecorder(ds_dist) as rec:
            res, master, _ = moe_ep_run(fa, ad, gm, tokens, mesh=mesh)
        res["all_to_all"] = a2a_device_ms(ds_dist, rec, MOE_EP_STEPS)
        res["bit_equal_no_group"] = {
            "losses": res["losses"] == ref["losses"],
            "masters": bool(torch.equal(master, ref_master))}
        res["phase11_step_ms_median"] = phase11_ms
        out["expert_mesh"] = res
        print(f"  train-moe-ep-125M at world 1 over nccl on an \"expert\" "
              f"mesh: losses {res['losses']}, median step "
              f"{res['step_ms_median']:.2f} ms (no group "
              f"{ref['step_ms_median']:.2f}, phase 11 {phase11_ms}), "
              f"all-to-alls {res['all_to_all']}, launches a step "
              f"{res['launches_per_step']}, bit-equal "
              f"{res['bit_equal_no_group']} on {card}", flush=True)
        if not all(res["bit_equal_no_group"].values()):
            fail(f"phase 43 (a): the expert mesh at world 1 is not the "
                 f"engine without a group bit for bit: "
                 f"{res['bit_equal_no_group']}")
        del master, ref_master
        torch.cuda.empty_cache()
        out["layer_bits"] = moe_ep_layer_bits(report)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"moe ep (c): two gloo ranks on this card, micro "
          f"{micro // 2} each, {MOE_EP_CHILD_STEPS} steps a run:",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="moe_ep_children_", dir="build")
    out["two_ranks"] = {}
    want = ref["losses"][:MOE_EP_CHILD_STEPS]
    try:
        kids = moe_ep_children(tmp, tokens, ref["num_params"])
        for name in ("ep2", "dp2"):
            got = kids[0][name]["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            step_ms = [max(a, b) for a, b in zip(kids[0][name]["step_ms"],
                                                 kids[1][name]["step_ms"])]
            kid_master = torch.load(os.path.join(tmp, f"{name}_master.pt"))
            gap = master_gap(kid_master.cuda(), snaps["snap"],
                             snaps["init"], snaps["expert_ranges"])
            del kid_master
            out["two_ranks"][name] = {
                "losses": got, "max_rel_diff_to_a": rel,
                "tol": TOL_MOE_EP_CHILD, "masters_to_a": gap,
                "masters_tol": TOL_MOE_EP_MASTER, "step_ms": step_ms,
                "num_params_a_rank": kids[0][name]["num_params"],
                "host_staged": [k[name]["host_staged"] for k in kids]}
            print(f"  {name}: losses {got}, max relative difference to "
                  f"(a) {rel:.3e}; fp32 masters after "
                  f"{MOE_EP_CHILD_STEPS} steps against (a)'s, gap over "
                  f"update {gap}; step ms (the slower rank's) {step_ms}, "
                  f"a rank's parameters {kids[0][name]['num_params']}, "
                  f"collectives through the host (gloo, explicit) "
                  f"{out['two_ranks'][name]['host_staged']} on {card}",
                  flush=True)
            if not rel < TOL_MOE_EP_CHILD:
                fail(f"phase 43 (c): {name} two-rank losses {got} are not "
                     f"within rtol {TOL_MOE_EP_CHILD} of (a)'s {want}")
            if not all(g["rel"] < TOL_MOE_EP_MASTER for g in gap.values()):
                fail(f"phase 43 (c): {name} two-rank masters are not "
                     f"within {TOL_MOE_EP_MASTER} of (a)'s update: {gap}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del snaps
    torch.cuda.empty_cache()
    print("moe ep (d): the grouped matmul on the ep-2 LUT:", flush=True)
    out["lut"] = moe_ep_lut_case(gm, torch.Generator(device="cuda")
                                 .manual_seed(43), report)
    out["seconds"] = time.perf_counter() - t0
    report["moe_ep"] = out
    print(f"phase 43: {out['seconds']:.1f} s", flush=True)
    return out


def moe_ep_kernel_entries(me):
    """What phase 43 adds to the kernels line: each kernel's launches on
    its runs by path."""
    runs = {"train_moe_ep_no_group": me["no_group"],
            "train_moe_ep": me["expert_mesh"]}
    return {name: {path: r["launches"][count] for path, r in runs.items()}
            for name, count in (("flash_fwd", "flash_fwd"),
                                ("flash_bwd", "flash_bwd_dkv"),
                                ("flash_bwd_dq", "flash_bwd_dq"),
                                ("adam", "adam"),
                                ("grouped_matmul", "grouped_matmul"),
                                ("grouped_matmul_dw", "grouped_matmul_dw"))}


def moe_ep_only(card):
    """Phase 43 alone, after phase 3's training-shape flash, Adam and
    grouped-matmul checks and phase 11 (the step beside)."""
    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.BUILD_INFO['seconds']:.1f} s (built="
          f"{_build.BUILD_INFO['built']})", flush=True)
    report = {"card": card, "build_seconds": _build.BUILD_INFO["seconds"]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions (the MoE training path's):",
          flush=True)
    ft, fb, adm, _ = check_train_kernels(
        fa, ad, gen, report, GPTNeoXConfig(**NEOX_125M).num_params())
    gmm = check_grouped_matmul(gm, gen, report)
    print("MoE training GPT-NeoX-125M (phase 11):", flush=True)
    tm = train(fa, ad, report, conf=MOE_TRAIN_CONFIG, gm=gm,
               key="train_moe")
    print_train("train-moe-125M", tm, card)
    me = run_moe_ep_phase(fa, ad, gm, report, card,
                          phase11_ms=tm["step_ms_median"])
    entries = moe_ep_kernel_entries(me)
    for name, count in (("flash_fwd", "flash_fwd"),
                        ("flash_bwd", "flash_bwd_dkv"),
                        ("flash_bwd_dq", "flash_bwd_dq"), ("adam", "adam"),
                        ("grouped_matmul", "grouped_matmul"),
                        ("grouped_matmul_dw", "grouped_matmul_dw")):
        entries[name]["train_moe"] = tm["launches"][count]
    kernels = train_kernel_rows(ft, fb, adm, gmm, entries)
    report["kernels"] = kernels
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_moe_ep.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wall: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}, default=str), flush=True)
    print(card, flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a decode window, a prefill call and "
                         "the training steps")
    ap.add_argument("--decode-only", metavar="DIR", nargs="?", const=".",
                    help="run only the paged-decode checks and timings of "
                         "phase 3, on the port of this checkout or of DIR "
                         "(a checkout of another commit, built there)")
    ap.add_argument("--sparse-only", metavar="DIR", nargs="?", const=".",
                    help="run only phase 13 (train-sparse-125M-16k, its "
                         "step profiled), on the port of this checkout or "
                         "of DIR")
    ap.add_argument("--ckpt-only", metavar="DIR", nargs="?", const=".",
                    help="run only phase 17 (checkpoint save / resume of "
                         "train-125M), on the port of this checkout or of "
                         "DIR")
    ap.add_argument("--gpt2-only", action="store_true",
                    help="run only phase 3's flat Adam at GPT-2 XL's size "
                         "and phases 20-23 (the GPT-2 family)")
    ap.add_argument("--serve-prefix-only", action="store_true",
                    help="run only phases 24-26 (the prefix cache and "
                         "speculative decoding)")
    ap.add_argument("--serve-chaos-only", action="store_true",
                    help="run only phases 27-28 (serving under failure)")
    ap.add_argument("--sentinel-only", action="store_true",
                    help="run only phases 29-30 (training under failure)")
    ap.add_argument("--fp16-only", action="store_true",
                    help="run only phase 3's fp16 cases and phases 31-35 "
                         "(fp16 training and serving, fp16 sparse and int8, "
                         "TiledLinear and a client optimizer)")
    ap.add_argument("--observability-only", action="store_true",
                    help="run only phase 39 (telemetry, monitor, flops "
                         "count, MoE routing statistics, env report), with "
                         "phase 3's training-shape kernel checks and phase "
                         "7 beside")
    ap.add_argument("--quant-train-only", action="store_true",
                    help="run only phases 36-38 (quantized training and "
                         "GPT-2 XL served with int8 weights), with phase 3's "
                         "training-shape kernel checks and phases 7 and 11 "
                         "for the numbers beside")
    ap.add_argument("--dp-only", action="store_true",
                    help="run only phase 41 (data parallel and ZeRO 0-2 "
                         "through a process group), after phase 3's flash "
                         "and Adam checks at the training shape")
    ap.add_argument("--zero3-only", action="store_true",
                    help="run only phase 42 (ZeRO stage 3: world 1 over "
                         "NCCL, bench.py row_zero3's quantities, two gloo "
                         "ranks on the card), after phase 3's flash and "
                         "Adam checks at the training shape")
    ap.add_argument("--moe-ep-only", action="store_true",
                    help="run only phase 43 (MoE across ranks: the "
                         "\"expert\" mesh at world 1 over NCCL, the layer "
                         "at ep 1, two gloo ranks on the card, the "
                         "grouped matmul on the expert-parallel LUT), after "
                         "phase 3's flash, Adam and grouped-matmul checks "
                         "and phase 11")
    ap.add_argument("--rl-only", action="store_true",
                    help="run only phase 40 (online RL), after phase 3's "
                         "checks of the kernels it launches (with "
                         "--profile, one rl-ppo-125M iteration profiled)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", flush=True)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.decode_only:
        return decode_only(args.decode_only, card)
    if args.sparse_only:
        return sparse_only(args.sparse_only, card)
    if args.ckpt_only:
        return ckpt_only(args.ckpt_only, card)
    if args.gpt2_only:
        return gpt2_only(card, args.profile)
    if args.serve_prefix_only:
        return serve_prefix_only(card)
    if args.serve_chaos_only:
        return serve_chaos_only(card)
    if args.sentinel_only:
        return sentinel_only(card, args.profile)
    if args.fp16_only:
        return fp16_only(card, args.profile)
    if args.quant_train_only:
        return quant_train_only(card)
    if args.observability_only:
        return observability_only(card)
    if args.rl_only:
        return rl_only(card, args.profile)
    if args.dp_only:
        return dp_only(card)
    if args.zero3_only:
        return zero3_only(card, args.profile)
    if args.moe_ep_only:
        return moe_ep_only(card)

    from deeperspeed_tpu_torch import GPTNeoXConfig
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import adam as ad
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deeperspeed_tpu_torch.ops.hopper import grouped_matmul as gm
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) "
          f"{info['path']}", flush=True)
    ptxas = ptxas_summary(info["log"])
    for row in ptxas:
        print(f"  ptxas {row['source']}: {row['kernel']}: {row['registers']} "
              f"registers, {row['barriers']} barriers, static shared "
              f"{row['static_smem']} B, spill stores {row['spill_stores']} "
              f"B, loads {row['spill_loads']} B", flush=True)

    sparse_luts = bsa.LayoutLuts(sparse_layout(SPARSE_L16G1, SPARSE_SEQ))
    taken = {"gmm_dw_wgmma_kernel (8 weights)": _build.kernel_info(
        "ds_grouped_matmul_dw_info", len(GMM_SIZES))}
    for part in bsa.PARTS:
        lut = sparse_luts.bwd if part == "dkv" else sparse_luts.fwd
        for D in fa.MMA_HEAD_DIMS:
            taken[f"block_sparse_{part}_mma_kernel<{D}> (phase 13's LUT)"] \
                = _build.kernel_info("ds_block_sparse_info",
                                     bsa.PART_CODES[part], D,
                                     lut[0].shape[-1])
    for D in da.CLUSTER_HEAD_DIMS:
        for pool in ("bf16", "int8"):
            taken[f"paged_decode_cluster_kernel<{D}> ({pool} pools, 16 "
                  f"pages a row)"] = _build.kernel_info(
                      "ds_paged_decode_info", D, int(pool == "int8"), 16)
    for name, row in taken.items():
        print(f"  on the device: {name}: {row['registers']} registers, "
              f"local (spill) {row['local_bytes']} B, static shared "
              f"{row['static_smem']} B, dynamic shared {row['dynamic_smem']} "
              f"B, {row['blocks_per_sm']} blocks an SM", flush=True)
    spilled = {name: row["local_bytes"] for name, row in taken.items()
               if name.startswith("block_sparse") and row["local_bytes"]}
    if spilled:
        fail(f"the block-sparse tensor-core kernels spill: {spilled}")
    del sparse_luts
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build": {"seconds": info["seconds"], "built": info["built"],
                        "ptxas": ptxas, "kernel_info": taken}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain versions:", flush=True)
    fl = check_prefill(fa, gen, report)
    de, de_serve = check_decode(da, report)
    di, di_serve = check_decode(da, report, int8=True)
    qrows = check_quant_matmul(qm, gen, report)
    n_params = GPTNeoXConfig(**NEOX_125M).num_params()
    ft, fb, adm, fbs = check_train_kernels(fa, ad, gen, report, n_params)
    gmm = check_grouped_matmul(gm, gen, report)
    bs = check_block_sparse(bsa, fa, gen, report)
    fm = check_masked_flash(bsa, fa, gen, report)
    check_sparse_crossover(bsa, fa, gen, report)
    bert_rows, _ = check_bert_attention(fa, gen, report)
    check_dropout_readout(fa, report)
    check_bwd_identity(fa, gen, report)
    fpk = check_packed_attention(fa, gen, report)
    axl = check_adam_xl(ad, gen, report)
    gxl = check_gpt2_attention(fa, da, gen, report)
    print("fp16 kernels vs plain versions:", flush=True)
    k16 = check_fp16_kernels(fa, da, gm, ad, bsa, qm, gen, report,
                             n_params)

    print("serving GPT-NeoX-125M (bf16):", flush=True)
    sv = serve(fa, da, report)
    print(f"  {sv['generated_tokens']} tokens in {sv['wall_s']:.3f} s: "
          f"{sv['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{sv['ttft_p50_ms']:.2f} ms, inter-token p50 "
          f"{sv['inter_token_p50_ms']:.2f} ms / p99 "
          f"{sv['inter_token_p99_ms']:.2f} ms, prefill_s "
          f"{sv['prefill_s']:.3f}, decode_s {sv['decode_s']:.3f}, "
          f"launches {sv['launches']} on {card}", flush=True)
    print("parity GPT-NeoX-125M (fp32, kernels vs plain):", flush=True)
    parity(report)
    print("training GPT-NeoX-125M (bf16, fp32 masters, ZeRO-2):", flush=True)
    tr = train(fa, ad, report, profile_step=args.profile)
    print(f"  {tr['steps']} steps: loss {tr['losses'][0]:.4f} -> "
          f"{tr['losses'][-1]:.4f} (eval {tr['eval_loss']:.4f}), median "
          f"step {tr['step_ms_median']:.1f} ms, {tr['tokens_per_s']:.0f} "
          f"tokens/s, peak memory {tr['max_memory_allocated_gb']:.2f} GiB, "
          f"launches per step {tr['launches_per_step']} on {card}",
          flush=True)
    print("training parity GPT-NeoX-125M (fp32, kernels vs plain):",
          flush=True)
    train_parity(report)
    print("serving-quant GPT-NeoX-125M (bf16 / int8 weights / int8 weights "
          "+ int8 KV):", flush=True)
    sq = serve_quant(fa, da, qm, report)
    for tag, r in sq["rungs"].items():
        print(f"  {tag}: decode {r['decode_tok_s']:.1f} tokens/s, stream "
              f"{r['stream_tok_s']:.1f} tokens/s, inter-token p50 "
              f"{r['inter_token_p50_ms']:.2f} ms, {r['prefill_calls']} "
              f"prefill calls, {r['decode_steps']} decode steps, launches "
              f"{r['launches']}, dtypes {r['dtypes']} on {card}", flush=True)
    kc = sq["kv_capacity"]
    print(f"  int8 KV capacity: {kc['bytes_per_token_bf16']} vs "
          f"{kc['bytes_per_token_int8']} bytes a token, "
          f"{kc['sessions_bf16']} vs {kc['sessions_int8']} sessions of "
          f"{kc['session_tokens']} tokens in {kc['pool_mb']} MB "
          f"(x{kc['capacity_ratio']:.3f})", flush=True)
    print("int8 parity GPT-NeoX-125M (fp32, int8 weights + int8 KV, kernels "
          "vs plain):", flush=True)
    parity_int8(da, qm, report)
    print("MoE training GPT-NeoX-125M (8 experts, top-2, sort dispatch; bf16, "
          "fp32 masters, ZeRO-2):", flush=True)
    tm = train(fa, ad, report, profile_step=args.profile,
               conf=MOE_TRAIN_CONFIG, gm=gm, key="train_moe")
    print(f"  {tm['steps']} steps: loss {tm['losses'][0]:.4f} -> "
          f"{tm['losses'][-1]:.4f} (eval {tm['eval_loss']:.4f}), median "
          f"step {tm['step_ms_median']:.1f} ms, {tm['tokens_per_s']:.0f} "
          f"tokens/s, peak memory {tm['max_memory_allocated_gb']:.2f} GiB, "
          f"{tm['num_params']} parameters, launches per step "
          f"{tm['launches_per_step']} on {card}", flush=True)
    print("MoE training parity GPT-NeoX-125M (fp32, kernels vs plain):",
          flush=True)
    train_parity(report, conf=MOE_TRAIN_CONFIG, key="train_moe_parity")
    print("sparse training train-sparse-125M-16k (fixed l16g1, bf16, fp32 "
          "masters, ZeRO-2):", flush=True)
    ts = train_sparse(fa, bsa, ad, report, profile_step=args.profile)
    print(f"  {ts['steps']} steps: loss {ts['losses'][0]:.4f} -> "
          f"{ts['losses'][-1]:.4f} (eval {ts['eval_loss']:.4f}), median "
          f"step {ts['step_ms_median']:.1f} ms, {ts['tokens_per_s']:.0f} "
          f"tokens/s, peak memory {ts['max_memory_allocated_gb']:.2f} GiB, "
          f"density {ts['density']:.4f}, launches per step "
          f"{ts['launches_per_step']} on {card}", flush=True)
    print("sparse training train-sparse-125M-16k with the bench row's remat "
          "(\"full\"):", flush=True)
    tsr = train_sparse(fa, bsa, ad, report, remat=True)
    print(f"  {tsr['steps']} steps: loss {tsr['losses'][0]:.4f} -> "
          f"{tsr['losses'][-1]:.4f}, median step {tsr['step_ms_median']:.1f} "
          f"ms (no remat {ts['step_ms_median']:.1f}), peak memory "
          f"{tsr['max_memory_allocated_gb']:.2f} GiB (no remat "
          f"{ts['max_memory_allocated_gb']:.2f}), launches per step "
          f"{ {k: v for k, v in tsr['launches_per_step'].items() if v} } on "
          f"{card}", flush=True)
    print("sparse training parity (fp32, kernels vs plain):", flush=True)
    pm = sparse_parity(fa, bsa, report, "train_sparse_parity_masked",
                       SPARSE_L4G1, dict(NEOX_125M), TRAIN_SEQ, 2, 2,
                       "masked_flash")
    pb = sparse_parity(fa, bsa, report, "train_sparse_parity_block_sparse",
                       SPARSE_L16G1, SPARSE_MODEL, 8192, 1, 1,
                       "block_sparse")
    print("BERT training train-bert-large-512 (bf16, fp32 masters, ZeRO-2, "
          "dropout 0.1):", flush=True)
    tb = train_bert(fa, bsa, ad, report, profile_step=args.profile)
    print(f"  {tb['steps']} steps: loss {tb['losses'][0]:.4f} -> "
          f"{tb['losses'][-1]:.4f} (eval {tb['eval_loss']:.4f}), median "
          f"step {tb['step_ms_median']:.1f} ms, {tb['tokens_per_s']:.0f} "
          f"tokens/s, model-flops share of the bf16 peak "
          f"{tb['model_flops_share']:.4f}, peak memory "
          f"{tb['max_memory_allocated_gb']:.2f} GiB, launches per step "
          f"{ {k: v for k, v in tb['launches_per_step'].items() if v} } on "
          f"{card}", flush=True)
    print("BERT training parity (fp32, 4 layers, kernels vs plain):",
          flush=True)
    bp = bert_parity(fa, bsa, report)
    tc = print_checkpoint(train_checkpoint(fa, ad, report), card)
    print("packed long-context training train-packed-125M-16k (bf16, fp32 "
          "masters, ZeRO-2, packing, remat):", flush=True)
    tp = train_packed(fa, bsa, ad, report, profile_step=args.profile)
    print_packed(tp, card)
    print("packed training parity (fp32, kernels vs plain):", flush=True)
    packed_parity(fa, bsa, report)
    bert_packed_parity(fa, bsa, report)
    tg, lg, sg, _ = run_gpt2_phases(fa, bsa, da, ad, report, card,
                                    args.profile)
    sp, sx, pp = run_prefix_phases(fa, da, qm, report, card)
    sc, cp = run_chaos_phases(fa, da, qm, report, card)
    chaos = {f"serve_chaos_{v}": sc[v] for v in ("clean", "storm")}
    tsn = run_sentinel_phases(fa, ad, report, card, args.profile)
    f16 = run_fp16_phases(fa, da, gm, ad, bsa, qm, report, card, bf16=tr,
                          profile_step=args.profile)
    qres = run_quant_phases(fa, ad, gm, da, qm, report, card, bf16=tr,
                            moe=tm)
    t39 = time.perf_counter()
    ob = run_observability_phases(fa, ad, gm, da, qm, report, card, sv=sv)
    report["phase39_seconds"] = time.perf_counter() - t39
    print(f"phase 39: {report['phase39_seconds']:.1f} s", flush=True)
    rl = run_rl_phases(fa, da, qm, ad, report, card, args.profile)
    dp = run_dp_phase(fa, ad, report, card, phase7_ms=tr["step_ms_median"])
    z3 = run_zero3_phase(fa, ad, report, card)
    me = run_moe_ep_phase(fa, ad, gm, report, card,
                          phase11_ms=tm["step_ms_median"])
    if args.profile:
        print("profile GPT-NeoX-125M (bf16):", flush=True)
        profile(report, card)
        print_profile("training step (gas 2 x micro 16 x 1024)",
                      tr["profile"], card)
        print(f"  flash kernels' share of device time: "
              f"{tr['profile']['device_share_flash']:.3f}", flush=True)
        print_profile("MoE training step (micro 8 x 1024, 8 experts top-2)",
                      tm["profile"], card)
        print(f"  flash kernels' share of device time: "
              f"{tm['profile']['device_share_flash']:.3f}", flush=True)
        print_profile("sparse training step (micro 2 x 16384, l16g1)",
                      ts["profile"], card)
        print(f"  block-sparse kernels' share of device time: "
              f"{ts['profile']['device_share_block_sparse']:.3f}",
              flush=True)
        print_profile("BERT training step (micro 20 x 512, BERT-large)",
                      tb["profile"], card)
        print(f"  flash kernels' share of device time: "
              f"{tb['profile']['device_share_flash']:.3f}", flush=True)
        tpp = tp["runs"]["full"]["profile"]
        print_profile("packed training step (2 x 16384, full remat)", tpp,
                      card)
        print(f"  flash kernels' share of device time: "
              f"{tpp['device_share_flash']:.3f}", flush=True)

    pallas = "deeperspeed_tpu/ops/pallas/"
    train_shape = "B=16 S=1024 H=12 D=64 bf16, causal"
    sparse_shape = "B=2 S=16384 H=12 D=64 bf16, fixed l16g1 causal"
    masked_shape = "B=16 S=1024 H=12 D=64 bf16, fixed l4g1 causal"
    sparse_design = "bf16 at D 64/128: the mma.sync tile steps of " \
        "csrc/attention_mma.cuh over the per-row LUT (dk/dv: the " \
        "transposed one); fp32 and D 256: FMA tiles"

    def sparse_designs(part):
        return {"train_sparse": ts["design_launches"][part],
                "train_sparse_remat": tsr["design_launches"][part],
                "train_sparse_parity": pb["design_launches"][part]}

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{pallas}flash_attention.py:497 (_fwd_kernel); "
                     f"{pallas}flash_attention.py:360, :378 "
                     f"(_fwd_single_kernel, _fwd_single_mh_kernel)",
         "launches": sv["launches"]["flash_fwd"] +
         tr["launches"]["flash_fwd"] + tm["launches"]["flash_fwd"] +
         tc["launches"]["flash_fwd"] + tp["launches"]["flash_fwd"] +
         tg["launches"]["flash_fwd"] + lg["launches"]["flash_fwd"] +
         sg["launches"]["flash_fwd"] + sum(
             r[n]["flash_fwd"] for r in (sp, sx)
             for n in ("base_launches", "launches")) + sum(
             r["launches"]["flash_fwd"] for r in chaos.values()) +
         tsn["launches"]["flash_fwd"],
         "launches_by_path": {"serve": sv["launches"]["flash_fwd"],
                              "train": tr["launches"]["flash_fwd"],
                              "train_moe": tm["launches"]["flash_fwd"],
                              "train_ckpt": tc["launches"]["flash_fwd"],
                              "train_packed": tp["launches"]["flash_fwd"],
                              "train_gpt2xl": tg["launches"]["flash_fwd"],
                              "train_gpt2xl_legacy": lg["launches"][
                                  "flash_fwd"],
                              "serve_gpt2xl": sg["launches"]["flash_fwd"],
                              "serve_prefix": sp["launches"]["flash_fwd"],
                              "serve_prefix_cache_off": sp["base_launches"][
                                  "flash_fwd"],
                              "serve_gpt2xl_spec": sx["launches"][
                                  "flash_fwd"],
                              "serve_gpt2xl_spec_cache_off": sx[
                                  "base_launches"]["flash_fwd"],
                              "train_sentinel": tsn["launches"][
                                  "flash_fwd"]} | {
             path: r["launches"]["flash_fwd"]
             for path, r in chaos.items()},
         "design": "bf16 at D 64/128: tensor cores (mma.sync, "
                   "csrc/attention_mma.cuh); fp32, D 256: FMA tile steps",
         "design_launches_by_path": {
             "serve": sv["design_launches"]["fwd"],
             "train": tr["design_launches"]["fwd"],
             "train_moe": tm["design_launches"]["fwd"],
             "train_ckpt": tc["design_launches"]["fwd"],
             "train_packed": tp["design_launches"]["fwd"],
             "serve_gpt2xl": sg["design_launches"]["fwd"],
             "train_gpt2xl": {tag: r["design_launches"]["fwd"]
                              for tag, r in tg["runs"].items()},
             "train_sentinel": tsn["design_launches"]["fwd"]} | {
             path: r["design_launches"]["fwd"]
             for path, r in chaos.items()},
         "max_abs_err": fl["max_abs_err_out"], "ms": fl["ms"],
         "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
         "shape": "B=4 S=1024 H=12 D=64 bf16, ragged segments",
         "tolerance": fl["tol_out"],
         "train_shape": {k: ft[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "max_abs_err_out")} | {"shape": train_shape},
         "packed_shape": packed_times(fpk, "fwd"),
         "gpt2xl_shape": gxl["flash_fwd"],
         "gpt2xl_prefill_shape": gxl["prefill"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:84",
         "launches": sv["launches"]["paged_decode"] +
         sg["launches"]["paged_decode"] + sum(
             r[n]["paged_decode"] for r in (sp, sx)
             for n in ("base_launches", "launches")) + sum(
             r["launches"]["paged_decode"] for r in chaos.values()),
         "launches_by_path": {"serve": sv["launches"]["paged_decode"],
                              "serve_gpt2xl": sg["launches"][
                                  "paged_decode"],
                              "serve_prefix": sp["launches"][
                                  "paged_decode"],
                              "serve_prefix_cache_off": sp[
                                  "base_launches"]["paged_decode"],
                              "serve_gpt2xl_spec": sx["launches"][
                                  "paged_decode"],
                              "serve_gpt2xl_spec_cache_off": sx[
                                  "base_launches"]["paged_decode"]} | {
             path: r["launches"]["paged_decode"]
             for path, r in chaos.items()},
         "design": DECODE_DESIGN,
         "design_launches": sv["decode_design_launches"],
         "design_launches_gpt2xl": sg["decode_design_launches"],
         "design_launches_serve_prefix": sp["decode_design_launches"],
         "design_launches_gpt2xl_spec": sx["decode_design_launches"],
         "design_launches_serve_chaos": {
             path: r["decode_design_launches"]
             for path, r in chaos.items()},
         "max_abs_err": de["max_abs_err"], "ms": de["ms"],
         "plain_ms": de["plain_ms"], "bound_ms": de["bound_ms"],
         "bound_by": de["bound_by"], "library_ms": de["library_ms"],
         "library": de["library"],
         "shape": f"{de['shape']} bf16, lengths {de['lengths_drawn']}",
         "tolerance": de["tol"], **decode_graph_times(de),
         "serving_shape": decode_shape_row(de_serve),
         "gpt2xl_shape": gxl["paged_decode"]},
        {"name": "flash_bwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{pallas}flash_attention.py:736, :763 "
                     f"(_bwd_single_kernel, _bwd_single_mh_kernel); "
                     f"{pallas}flash_attention.py:948, :1038 "
                     f"(_bwd_dkv_kernel, _bwd_dq_kernel)",
         "launches": tr["launches"]["flash_bwd_dkv"] +
         tm["launches"]["flash_bwd_dkv"] + tc["launches"]["flash_bwd_dkv"] +
         tp["launches"]["flash_bwd_dkv"] + tg["launches"]["flash_bwd_dkv"] +
         lg["launches"]["flash_bwd_dkv"] + tsn["launches"]["flash_bwd_dkv"],
         "launches_by_kernel": {"dkv": tr["launches"]["flash_bwd_dkv"] +
                                tm["launches"]["flash_bwd_dkv"] +
                                tc["launches"]["flash_bwd_dkv"] +
                                tp["launches"]["flash_bwd_dkv"] +
                                tg["launches"]["flash_bwd_dkv"] +
                                lg["launches"]["flash_bwd_dkv"] +
                                tsn["launches"]["flash_bwd_dkv"],
                                "dq": tr["launches"]["flash_bwd_dq"] +
                                tm["launches"]["flash_bwd_dq"] +
                                tc["launches"]["flash_bwd_dq"] +
                                tp["launches"]["flash_bwd_dq"] +
                                tg["launches"]["flash_bwd_dq"] +
                                lg["launches"]["flash_bwd_dq"] +
                                tsn["launches"]["flash_bwd_dq"]},
         "launches_by_path": {"train": tr["launches"]["flash_bwd_dkv"],
                              "train_moe": tm["launches"]["flash_bwd_dkv"],
                              "train_ckpt": tc["launches"]["flash_bwd_dkv"],
                              "train_packed": tp["launches"][
                                  "flash_bwd_dkv"],
                              "train_gpt2xl": tg["launches"][
                                  "flash_bwd_dkv"],
                              "train_gpt2xl_legacy": lg["launches"][
                                  "flash_bwd_dkv"],
                              "train_sentinel": tsn["launches"][
                                  "flash_bwd_dkv"]},
         "design_launches_by_path": {
             "train": {k: tr["design_launches"][k] for k in ("dkv", "dq")},
             "train_moe": {k: tm["design_launches"][k]
                           for k in ("dkv", "dq")},
             "train_ckpt": {k: tc["design_launches"][k]
                            for k in ("dkv", "dq")},
             "train_packed": {k: tp["design_launches"][k]
                              for k in ("dkv", "dq")},
             "train_sentinel": {k: tsn["design_launches"][k]
                                for k in ("dkv", "dq")}},
         "max_abs_err": max(fb[f"max_abs_err_{g}"]
                            for g in ("dq", "dk", "dv")),
         "ms": fb["ms"], "plain_ms": fb["plain_ms"],
         "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
         "library_ms": fb["library_ms"],
         "shape": train_shape + " (dkv + dq kernels)",
         "tolerance": fb["tol"],
         "segments_shape": {k: fbs[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "max_abs_err_dq", "max_abs_err_dk", "max_abs_err_dv")} | {
             "shape": "B=4 S=1024 H=12 D=64 bf16, ragged segments "
                      "(SDPA with the bool mask as library)"},
         "packed_shape": packed_times(fpk, "bwd"),
         "gpt2xl_shape": gxl["flash_bwd"]},
        {"name": "adam", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/adam.cu",
         "replaces": f"{pallas}optimizer.py:34 (_adam_kernel)",
         "launches": tr["launches"]["adam"] + tm["launches"]["adam"] +
         tc["launches"]["adam"] + tp["launches"]["adam"] +
         tg["launches"]["adam"] + lg["launches"]["adam"] +
         tsn["launches"]["adam"],
         "launches_by_path": {"train": tr["launches"]["adam"],
                              "train_moe": tm["launches"]["adam"],
                              "train_ckpt": tc["launches"]["adam"],
                              "train_packed": tp["launches"]["adam"],
                              "train_gpt2xl": tg["launches"]["adam"],
                              "train_gpt2xl_legacy": lg["launches"][
                                  "adam"],
                              "train_sentinel": tsn["launches"]["adam"]},
         "variant_launches_gpt2xl": {tag: r["adam_variants"]
                                     for tag, r in tg["runs"].items()},
         "gpt2xl_shapes": axl,
         "max_abs_err": adm["max_abs_err_p"], "ms": adm["ms"],
         "plain_ms": adm["plain_ms"], "bound_ms": adm["bound_ms"],
         "bound_by": adm["bound_by"], "library_ms": adm["library_ms"],
         "shape": f"n={n_params} fp32 p/m/v, bf16 g, bf16 copy",
         "tolerance": adm["tol"]},
        {"name": "quant_matmul", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/quant_matmul.cu",
         "replaces": f"{pallas}quant_matmul.py:152 (_wq_kernel)",
         "launches": sum(r["launches"]["quant_matmul"]
                         for r in sq["rungs"].values()),
         "launches_by_rung": {t: r["launches"]["quant_matmul"]
                              for t, r in sq["rungs"].items()},
         "parity_launches_int8_draft": pp["b"]["launches"]["kernels"][
             "quant_matmul"],
         "chaos_parity_launches_int8": {
             path: cp["b"]["launches"][path]["quant_matmul"]
             for path in ("kernels", "cache_off", "clean")},
         "design": "bf16: wgmma fed by TMA through an mbarrier ring, the "
                   "int8 tile widened to bf16 in shared memory, K split "
                   "over a cluster (csrc/hopper_gemm.cuh); fp32: FMA tiles",
         "design_launches_by_rung": {
             t: r["quant_matmul_design_launches"]
             for t, r in sq["rungs"].items()},
         "max_abs_err": qrows[0]["max_abs_err"], "ms": qrows[0]["ms"],
         "plain_ms": qrows[0]["plain_ms"], "bound_ms": qrows[0]["bound_ms"],
         "bound_by": qrows[0]["bound_by"],
         "library_ms": qrows[0]["library_ms"],
         "shape": "M=16 K=768 N=3072 bf16 (decode rows, mlp-in weight)",
         "tolerance": f"{TOL_QMM[torch.bfloat16]} x max|ref|",
         **graph_times(qrows[0]),
         "host_us_per_call_M16": report["quant_matmul_readout"][
             "host_us_per_call_M16"],
         "other_shapes": [{k: r[k] for k in (
             "M", "K", "N", "plan", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by", "max_abs_err")} | graph_times(r)
             for r in qrows[1:]]},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/paged_decode.cu",
         "replaces": f"{pallas}decode_attention.py:152 "
                     f"(_decode_kernel_quant)",
         "launches": sq["rungs"]["int8w_int8kv"]["launches"][
             "paged_decode_int8"],
         "parity_launches_int8_prefix_spec": pp["b"]["launches"][
             "kernels"]["paged_decode_int8"],
         "chaos_parity_launches_int8": {
             path: cp["b"]["launches"][path]["paged_decode_int8"]
             for path in ("kernels", "cache_off", "clean")},
         "design": DECODE_DESIGN,
         "design_launches": sq["rungs"]["int8w_int8kv"][
             "decode_design_launches"]["paged_decode_int8"],
         "max_abs_err": di["max_abs_err"], "ms": di["ms"],
         "plain_ms": di["plain_ms"], "bound_ms": di["bound_ms"],
         "bound_by": di["bound_by"], "library_ms": di["library_ms"],
         "library": di["library"],
         "shape": f"{di['shape']} int8 pools, bf16 scales, bf16 q, "
                  f"lengths {di['lengths_drawn']}",
         "tolerance": di["tol"], **decode_graph_times(di),
         "serving_shape": decode_shape_row(di_serve)},
        {"name": "grouped_matmul", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:121 (_fwd_kernel, via "
                     f"_gmm_pallas :142; also the dx product)",
         "launches": tm["launches"]["grouped_matmul"],
         "design": "bf16: wgmma m64n256k16 fed by TMA through an mbarrier "
                   "ring (csrc/hopper_gemm.cuh); fp32: FMA tiles",
         "design_launches": tm["design_launches"]["grouped_matmul"],
         "max_abs_err": gmm[0]["max_abs_err"], "ms": gmm[0]["ms"],
         "graph_ms": gmm[0]["graph_ms"], "plain_ms": gmm[0]["plain_ms"],
         "bound_ms": gmm[0]["bound_ms"], "bound_by": gmm[0]["bound_by"],
         "library_ms": gmm[0]["library_ms"],
         "library_graph_ms": gmm[0]["library_graph_ms"],
         "shape": gmm_shape(gmm[0]),
         "tolerance": f"{TOL_GMM[torch.bfloat16]} x max|ref|",
         "dx": [{k: r[k] for k in (
             "K", "N", "dx_ms", "dx_graph_ms", "dx_library_ms",
             "dx_library_graph_ms", "dx_bound_ms", "dx_bound_by",
             "max_abs_err_dx")} for r in gmm],
         "other_shapes": [{k: r[k] for k in (
             "K", "N", "ms", "graph_ms", "plain_ms", "library_ms",
             "library_graph_ms", "bound_ms", "bound_by", "max_abs_err")}
             for r in gmm[1:]]},
        {"name": "grouped_matmul_dw", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": f"{pallas}grouped_matmul.py:174 (_dw_kernel, via "
                     f"_dw_pallas :204)",
         "launches": tm["launches"]["grouped_matmul_dw"],
         "design": "bf16: persistent wgmma m64n256k16 with A = x^T and B = "
                   "dy both MN-major, fed by TMA through an mbarrier ring "
                   "(csrc/hopper_gemm.cuh); fp32: FMA tiles",
         "design_launches": tm["design_launches"]["grouped_matmul_dw"],
         "max_abs_err": gmm[0]["max_abs_err_dw"], "ms": gmm[0]["dw_ms"],
         "graph_ms": gmm[0]["dw_graph_ms"],
         "plain_ms": gmm[0]["dw_plain_ms"],
         "bound_ms": gmm[0]["dw_bound_ms"],
         "bound_by": gmm[0]["dw_bound_by"],
         "library_ms": gmm[0]["dw_library_ms"],
         "library_graph_ms": gmm[0]["dw_library_graph_ms"],
         "shape": gmm_shape(gmm[0]) + ", fp32 dW",
         "tolerance": f"{TOL_GMM_DW} x max|ref|",
         "other_shapes": [{"K": r["K"], "N": r["N"], "ms": r["dw_ms"],
                           "graph_ms": r["dw_graph_ms"],
                           "plain_ms": r["dw_plain_ms"],
                           "library_ms": r["dw_library_ms"],
                           "library_graph_ms": r["dw_library_graph_ms"],
                           "bound_ms": r["dw_bound_ms"],
                           "bound_by": r["dw_bound_by"],
                           "max_abs_err": r["max_abs_err_dw"]}
                          for r in gmm[1:]]},
        {"name": "block_sparse_fwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/block_sparse_attention.cu",
         "replaces": f"{pallas}block_sparse_attention.py:140 "
                     f"(_sparse_fwd_kernel, via sparse_attention_fwd :213)",
         "launches": ts["launches"]["block_sparse_fwd"] +
         tsr["launches"]["block_sparse_fwd"] +
         pb["launches"]["block_sparse_fwd"],
         "launches_by_path": {"train_sparse": ts["launches"][
             "block_sparse_fwd"], "train_sparse_remat": tsr["launches"][
             "block_sparse_fwd"], "train_sparse_parity": pb["launches"][
             "block_sparse_fwd"]},
         "design": sparse_design,
         "design_launches": sparse_designs("fwd"),
         "max_abs_err": max(bs["max_abs_err_out"], bs["max_abs_err_lse"]),
         "ms": bs["fwd_ms"], "plain_ms": bs["plain_fwd_ms"],
         "bound_ms": bs["fwd_bound_ms"], "bound_by": bs["fwd_bound_by"],
         "library_ms": bs["library_fwd_ms"],
         "library": f"SDPA under the bool token mask, B="
                    f"{bs['library_batch']}",
         "masked_flash_ms": bs["masked_fwd_ms"],
         "dense_flash_ms": bs["dense_flash_fwd_ms"],
         "shape": sparse_shape, "tolerance": bs["tol_out"]},
        {"name": "block_sparse_dkv", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/block_sparse_attention.cu",
         "replaces": f"{pallas}block_sparse_attention.py:281 "
                     f"(_sparse_dkv_kernel, via sparse_attention_bwd :393)",
         "launches": ts["launches"]["block_sparse_dkv"] +
         tsr["launches"]["block_sparse_dkv"] +
         pb["launches"]["block_sparse_dkv"],
         "design": sparse_design,
         "design_launches": sparse_designs("dkv"),
         "max_abs_err": max(bs["max_abs_err_dk"], bs["max_abs_err_dv"]),
         "ms": bs["dkv_ms"], "plain_ms": bs["plain_bwd_ms"],
         "plain": "the plain backward (dq, dk, dv together)",
         "bound_ms": bs["dkv_bound_ms"], "bound_by": bs["dkv_bound_by"],
         "library_ms": bs["library_bwd_ms"],
         "library": f"SDPA backward (dq, dk, dv) under the bool token "
                    f"mask, B={bs['library_batch']}",
         "masked_flash_bwd_ms": bs["masked_bwd_ms"],
         "dense_flash_bwd_ms": bs["dense_flash_bwd_ms"],
         "shape": sparse_shape, "tolerance": bs["tol_bwd"]},
        {"name": "block_sparse_dq", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/block_sparse_attention.cu",
         "replaces": f"{pallas}block_sparse_attention.py:343 "
                     f"(_sparse_dq_kernel, via sparse_attention_bwd :393)",
         "launches": ts["launches"]["block_sparse_dq"] +
         tsr["launches"]["block_sparse_dq"] +
         pb["launches"]["block_sparse_dq"],
         "design": sparse_design,
         "design_launches": sparse_designs("dq"),
         "max_abs_err": bs["max_abs_err_dq"], "ms": bs["dq_ms"],
         "plain_ms": bs["plain_bwd_ms"],
         "plain": "the plain backward (dq, dk, dv together)",
         "bound_ms": bs["dq_bound_ms"], "bound_by": bs["dq_bound_by"],
         "library_ms": bs["library_bwd_ms"],
         "library": f"SDPA backward (dq, dk, dv) under the bool token "
                    f"mask, B={bs['library_batch']}",
         "shape": sparse_shape, "tolerance": bs["tol_bwd"]},
        {"name": "flash_masked_fwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{pallas}flash_attention.py:209 (_apply_layout_mask) "
                     f"on :497 (_fwd_kernel), via make_masked_flash_attention "
                     f":1482",
         "launches": pm["launches"]["flash_masked_fwd"],
         "max_abs_err": max(fm["max_abs_err_out"], fm["max_abs_err_lse"]),
         "ms": fm["fwd_ms"], "plain_ms": fm["plain_fwd_ms"],
         "bound_ms": fm["fwd_bound_ms"], "bound_by": fm["fwd_bound_by"],
         "library_ms": fm["library_fwd_ms"],
         "library": f"SDPA under the bool token mask, B="
                    f"{fm['library_batch']}",
         "block_sparse_ms": fm["block_sparse_fwd_ms"],
         "dense_flash_ms": fm["dense_flash_fwd_ms"],
         "shape": masked_shape, "tolerance": fm["tol_out"]},
        {"name": "flash_masked_bwd", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{pallas}flash_attention.py:209 (_apply_layout_mask) "
                     f"on :948, :1038 (_bwd_dkv_kernel, _bwd_dq_kernel), "
                     f"via make_masked_flash_attention :1482",
         "launches": pm["launches"]["flash_masked_bwd_dkv"],
         "launches_by_kernel": {
             "dkv": pm["launches"]["flash_masked_bwd_dkv"],
             "dq": pm["launches"]["flash_masked_bwd_dq"]},
         "max_abs_err": max(fm[f"max_abs_err_{g}"]
                            for g in ("dq", "dk", "dv")),
         "ms": fm["bwd_ms"], "plain_ms": fm["plain_bwd_ms"],
         "bound_ms": fm["bwd_bound_ms"], "bound_by": fm["bwd_bound_by"],
         "library_ms": fm["library_bwd_ms"],
         "library": f"SDPA backward under the bool token mask, B="
                    f"{fm['library_batch']}",
         "block_sparse_ms": fm["block_sparse_bwd_ms"],
         "dense_flash_ms": fm["dense_flash_bwd_ms"],
         "shape": masked_shape + " (dkv + dq kernels)",
         "tolerance": fm["tol_bwd"]},
    ]
    bert_shape = "B=20 S=512 H=16 D=64 bf16, not causal, ragged key bias " \
        "(one batch row all masked), rate 0.1"
    bert_row = next(r for r in bert_rows if r["dtype"] == str(torch.bfloat16)
                    and r["rate"] == 0.1)
    bert_fp32 = [r for r in bert_rows if r["dtype"] == str(torch.float32)]
    kernels += [
        {"name": "flash_fwd_kbias_dropout", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{pallas}flash_attention.py:360, :378, :497 "
                     f"(_fwd_single_kernel, _fwd_single_mh_kernel, "
                     f"_fwd_kernel with use_bias, dropout_rate), via "
                     f"flash_attention_kbias :1374 and flash_attention_train "
                     f":1421 (_dropout_keep :231)",
         "launches": tb["launches"]["flash_fwd_kbias_dropout"],
         "launches_by_path": {"train_bert": tb["launches"][
             "flash_fwd_kbias_dropout"], "train_bert_parity": bp[
             "launches"]["flash_fwd_kbias_dropout"]},
         "design_launches": tb["design_launches"]["fwd"],
         "max_abs_err": max(bert_row["max_abs_err_out"],
                            bert_row["max_abs_err_lse"]),
         "max_abs_err_fp32": max(r["max_abs_err_out"] for r in bert_fp32),
         "ms": bert_row["ms"], "plain_ms": bert_row["plain_ms"],
         "bound_ms": bert_row["bound_ms"], "bound_by": bert_row["bound_by"],
         "library_ms": bert_row["library_ms"],
         "library": bert_row["library"], "shape": bert_shape,
         "tolerance": bert_row["tol_out"],
         "tolerance_fp32": TOL_FLAGS[torch.float32]["out"]},
        {"name": "flash_bwd_kbias_dropout", "route": "cuda",
         "source": "deeperspeed_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{pallas}flash_attention.py:736, :763, :948, :1038 "
                     f"(_bwd_single_kernel, _bwd_single_mh_kernel, "
                     f"_bwd_dkv_kernel, _bwd_dq_kernel with use_bias, "
                     f"dropout_rate), via the vjps :1402-1418, :1457-1479",
         "launches": tb["launches"]["flash_dkv_kbias_dropout"],
         "launches_by_kernel": {
             "dkv": tb["launches"]["flash_dkv_kbias_dropout"],
             "dq": tb["launches"]["flash_dq_kbias_dropout"]},
         "design_launches": {k: tb["design_launches"][k]
                             for k in ("dkv", "dq")},
         "max_abs_err": max(bert_row[f"max_abs_err_{g}"]
                            for g in ("dq", "dk", "dv")),
         "max_abs_err_fp32": max(r[f"max_abs_err_{g}"] for r in bert_fp32
                                 for g in ("dq", "dk", "dv")),
         "ms": bert_row["bwd_ms"], "plain_ms": bert_row["plain_bwd_ms"],
         "bound_ms": bert_row["bwd_bound_ms"],
         "bound_by": bert_row["bwd_bound_by"],
         "library_ms": bert_row["library_bwd_ms"],
         "library": bert_row["library"] + " (backward)",
         "shape": bert_shape + " (dkv + dq kernels)",
         "tolerance": bert_row["tol_bwd"],
         "tolerance_fp32": TOL_FLAGS[torch.float32]["bwd"]},
    ]
    kernels += fp16_kernel_rows(k16, *f16)
    merge_quant_entries(kernels, quant_kernel_entries(*qres))
    merge_obs_entries(kernels, obs_kernel_entries(ob))
    merge_obs_entries(kernels, rl_kernel_entries(rl))
    merge_obs_entries(kernels, dp_kernel_entries(dp))
    merge_obs_entries(kernels, zero3_kernel_entries(z3))
    merge_obs_entries(kernels, moe_ep_kernel_entries(me))
    os.makedirs(REPORT_DIR, exist_ok=True)
    report["kernels"] = kernels
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(f"wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
