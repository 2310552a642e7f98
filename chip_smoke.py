#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: the FLARE PDE
surrogate's inference and training, the four Table-1 baselines trained
beside it, the causal FLARE LM's serving,
Qwen2-1.5B and Phi-3-mini served from the paged KV pool (Qwen2-1.5B also
with the prefix cache), the MLA models DeepSeek-V2-Lite (MLA + MoE) and
MiniCPM3-4B served through the paged kernel's MLA instance, the dense
family's prefill (Qwen2-1.5B, Phi-3-mini) through the flash-attention
kernels (bf16 on the tensor cores, fp32 on the TF32 tensor cores), training
flare_lm and Qwen2-1.5B at full size, RWKV-6 3B and Zamba2-7B served at
full size (Zamba2's shared attention through the paged and flash kernels),
and the encoder-decoder SeamlessM4T-large-v2 prefilled and decoded at full
size with its attention encoder and its FLARE encoder (the fused FLARE
kernels in bf16 and fp32, its three attentions through the flash kernels),
and trained at full size with both encoders (the FLARE encoder's fused
backward in bf16 at D=64), and RWKV-6 3B trained at full size.

    python3 chip_smoke.py
    python3 chip_smoke.py --only deepseek_v2_lite_16b   # build, device lines, one phase

Run from the root of a checkout. ``--only`` runs the build, the device
lines and one phase from its own set-up (``paged``, ``flash``, ``spectral``,
``tune``, ``lm``, ``phi3``, ``deepseek_v2_lite_16b``, ``minicpm3_4b``,
``rwkv6_3b``, ``zamba2_7b``, ``seamless_m4t_large_v2``, ``train_seamless_m4t_large_v2``,
``train_rwkv6_3b``, ``pde_baselines``), then the card's line
and ``{"ok": true, "only": ...}``;
it prints no kernels line. It imports only ``repro_torch`` (from
``src/``), never JAX or the JAX package. Phases, each of which raises on
failure so the script exits non-zero:

1. the card: exits non-zero without CUDA; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel) and prints the seconds taken and ptxas's
   register/shared-memory use and spills of the D=8 kernels (the forward's
   encode_tc and decode_tc and the backward's three passes, all on the
   tensor cores), the causal kernels at D=32 and 128 (causal_tc, bf16;
   causal_tf32, fp32; both on the tensor cores), the paged kernel's decode
   instances (page dtype x query rows a block), MLA instances (bf16, int8
   and fp8 pages x padded D; fp32 pages x padded D) and encode instances
   (padded D, plain or scaled), the three flash kernels, and ptxas's
   warnings;
3. kernels on random operands: each CUDA kernel (encode, decode, fused
   forward, fused backward) against its plain PyTorch version, bf16 at full
   width (H=8, M=2048, D=8, B=1, N=40,000) and a ragged shape (M=16, N=97)
   in fp32 and bf16. Each output is held by absolute error (fp32 1e-4, bf16
   2e-2) and by error over the plain output's largest magnitude (fp32 1e-5,
   bf16 1e-2); the den and lse of the fused forward only by the latter;
3b. ``kernels paged``: the paged-attention kernel on random operands, G in
   {1, 6, 2048} x D in {8, 24, 96, 128} (24 and 96 at the padded widths 32
   and 128), pages fp32 / bf16 / int8 / fp8 (with
   per-row scales), with and without q2 k2, lanes of 0, 200 and 384 tokens,
   a shuffled page table whose unmapped entries point at a NaN trash row:
   fp32 queries against the plain version in fp64, bf16 queries over bf16
   pages against the plain version on the same inputs; each limit must
   reject the plain version with one page of the longest lane left out;
3c. ``kernels flash``: the flash-attention kernels on random operands laid
   out as the model gives them, 6 query heads over 1, 2 or 6 KV heads
   (unexpanded), D in {8, 16, 24, 32, 64, 96, 128} x (Sq, Skv) in {97/97,
   300/300, 128/64} x causal, full and causal with a window of 24: fp32 (the
   TF32 tensor cores) against the plain version in fp64; bf16 on both bf16 routes
   (the wgmma kernel, which ``flash_route`` must pick, and ``bf16_mma``)
   against the plain version on the same operands (fp32 1e-5, bf16 1e-2 of
   max |plain|) and beyond bf16's output rounding against the fp64 plain
   version on the bf16 values (1e-5); each limit must reject the fp64 plain
   version with the 64-key tile at Skv/2 left out, and rows that see no key
   must come out exactly 0; then the bf16 calls ``flash_route`` itself
   sends off TMA (D=100, and D=128 with a base 8 bytes off) under the same
   checks, each launch's route (``bf16_mma``) asserted by count and by the
   profiler's kernel names (``route`` line: ``flash_bf16_kernel``, neither
   tensor-core kernel of the other routes);
4. kernels on the main path's operands: block 0's own q, k, v of the model
   at pde_40k (B=8, N=40,000) and pde_1m (B=1, N=1,048,576), fp32, every
   batch element and head, the plain versions run a head at a time. Each
   output must also reject a plain version with one token tile (encode) or
   latent tile (decode) left out, so the limits are shown to bite. Times by
   CUDA events of the kernel, the plain version and one
   ``F.scaled_dot_product_attention`` yardstick per SDPA call, at both
   shapes (the JSON line carries pde_40k's), beside the bound and the two
   floors of the tensor-core design (FWD_EXPS exps and FWD_PRODUCTS
   products a pair, each three TF32 MMAs; half of each for the encode and
   the decode alone);
4b. the backward kernel on the same operands with a seeded dy: dq, dk and dv
   against the plain backward in fp64 on the kernel forward's residuals, a
   head at a time, chunked over tokens; each must reject a plain backward
   that dropped one 256-token tile of dZ, and dk also one that dropped one
   256-latent tile. Timed beside its plain version and autograd's backward
   through two ``F.scaled_dot_product_attention`` calls, with the bound of
   seven fp32 products and the two floors of the tensor-core design (its
   exps at the card's top SM clock, its products split three ways at the
   TF32 peak);
4c. ``tune``: the launch-parameter autotuner (``backends/autotune.py``)
   on a cache file of its own (every other phase runs with autotuning off
   and an empty cache): ``pallas``, ``packed`` and ``packed_shard`` (on a
   group of one) resolved with autotuning forced on at block 0's shape at
   pde_40k and pde_1m, fp32, each timing its candidates (the rows a block
   and the encode's token split; forward, and for the fused kinds the
   backward too) and storing the winner under a key naming torch, CUDA and
   the card; a ``tune`` line a kind and shape with every candidate's ms,
   the default's and the winner's; every candidate held against the plain
   version in fp64 as in phases 4 and 4b (a lost tile rejected); resolved
   again with autotuning off, a cache hit carrying the winner; ``tune
   time``: each tuned kernel row under the default and under the winner;
   ``tune model``: one pde_40k forward and one train step under the tuned
   ``packed`` plan against the default plan (PATH_TOL, TRAIN_TOL);
5. the slice end to end: ``get_model(flare_pde)`` from a seed, whose infer
   plan must be ``packed``; point-cloud requests at pde_40k and one pde_1m
   forward, with launch counts zeroed just before and read just after; the
   same requests under policy ``pallas`` (the encode and decode kernels);
   both kernel paths held against the plain ``sdpa`` path on all 8 batch
   elements of pde_40k (abs and rel 1e-3 after 8 blocks); profiler
   breakdowns of the packed and the pallas forwards, each asserting that
   the tensor-core encode_tc and decode_tc kernels ran (``route`` lines);
6. training at full width and depth: ``Trainer.fit`` of ``get_model(flare_pde)``,
   whose train plan must be ``packed``, for 20 steps at pde_40k with
   checkpoints into a temporary directory (restored after), launch counts
   zeroed just before and read just after (8 fused forwards and 8 fused
   backwards a step, no plain backward), ms per step, peak GiB, the loss at
   every step (the mean of the last 5 must be below the first 5's), a
   profiler breakdown of one step (asserting the tensor-core forward
   kernels ran), and the AdamW update's own time;
6b. 3 train steps at pde_1m (B=1, N=1,048,576) through the kernels, with
   their ms per step, peak GiB and launches (8 + 8 a step);
5a. ``spectral``: ``core/spectral.py``'s ``spectrum_by_head`` (Algorithm
   1) on block 0's latent queries and the first example's keys at pde_40k
   (H=8, M=2,048, N=40,000, D=8) in fp32 against the same function in fp64
   on the card, within 1e-5 of the largest eigenvalue; the fp64 spectrum
   without the keys' last 1,024 tokens must fail that limit; each head's
   effective rank and the seconds printed;
5b. ``kernels paged`` on block 0's encode at pde_40k (B=1; G=2048, D=8,
   pages of 16 with an identity table) against fp64, a head at a time, with
   its times; ``path flare_pde paged``: ``get_model(flare_pde)`` under
   policy ``paged`` on one pde_40k example, 8 paged launches counted, held
   against the ``sdpa`` path at 1e-3 abs and rel;
7. the kernel path against the plain path in training: 5 steps under
   ``packed`` and 5 under ``sdpa`` from the same weights and batches at B=2,
   N=4,096, loss and grad_norm per step and the parameters after;
7b. ``pde baselines`` (run last, after phase 14, so that its largest
   tensors come after the host-paced phases): the Table-1 mixers at
   flare_pde's width (C=64, H=8,
   D=8, 8 blocks, M=2048 latents, slices or projected length), weights from
   seed 0. Each baseline (vanilla, Perceiver, Linformer, Transolver) at B=1,
   N=4,096 against the fp64 plain oracle (the plain ``sdpa`` route on fp64
   weights and inputs): the forward within 1e-5 of max |y|, every gradient
   of ``surrogate_loss`` within 1e-4 of its leaf's max |g| (leaves whose
   exact gradient is zero: of the tree's), the fp32 plain route's reading
   printed beside; the oracle with the last 1,024 rows of its last
   attention call zeroed must fail both. Then pde_16k (Darcy at grid 128,
   B=8, N=16,384, the Linformer's cap): 5 AdamW steps of each mixer through
   ``make_train_step`` over ``surrogate_loss`` (FLARE under its ``packed``
   plan, a counted window: 40 fused forward and 40 fused backward launches),
   ms a step (median of steps 2-5), ms a forward, peak GiB, parameters,
   losses; a profiled step of each baseline must show SDPA's
   memory-efficient kernels (``fmha_cutlassF`` / ``fmha_cutlassB``) and no
   materialised softmax, their ops dispatched once a call each way and no
   math-route op, its peak below one block's scores and softmax. Last, one block's forward at B=1 over N in
   {4,096; 16,384; 40,000; 2^20} beside FLARE's (fig. 8; the Linformer to
   16,384, vanilla to 40,000), and the phase's seconds;
8. the causal kernel on random operands: bf16 at flare_lm's width (H=16,
   M=512, D=128, B=1, T=8,192) and a ragged shape (T=97, M=16, D=8) in fp32
   and bf16, held as in phase 3, and the full-width bf16 output (the
   tensor cores) also beyond bf16's output rounding against the fp64 plain
   version on the same bf16 values (``Checks.hold_rounded``, 1e-5), which
   must reject the 64-token state tile at T/2 left out; at D 24, 40 and 96
   (padded widths 32, 64, 128) fp32 against the plain version in fp64 with
   a dropped-tile rejection and bf16 against the plain version; its bf16
   time at D=96 beside D=128 at flare_lm's width;
9. ``get_model(flare_lm)`` at full width and depth (24 layers, d_model 2048,
   2.6B parameters) from seed 0, whose infer plan must be ``causal_pallas``;
   the seconds the card takes to draw the weights (``card_init``). The
   causal kernel on layer 0's own q, k, v for ``TokenStream`` tokens at B=1, T=32,768
   (prefill_32k's length; its batch of 32 cut to 1): in fp32 against the
   plain version in fp64, a head at a time, at 1e-5 of max |plain|, which
   must reject a plain version that left one 64-token kernel tile out of the
   carried state; in bf16, as the model runs it (the tensor cores), against
   the plain version on the same operands at 1e-2 of max |plain| and beyond
   bf16's output rounding against the fp64 plain version on the same bf16
   values at 1e-5, which must reject the same lost tile rounded to bf16.
   Times of the kernel (bf16 and fp32), its bounds, each design's three
   floors (its products as it issues them at the bf16 or TF32 peak, its two
   exps a pair, its fp32 partials' round trip) and its plain version, and a
   profiler breakdown of the plain version (its device busy share);
10. ``Model.forward`` at B=1, T=32,768 in bf16: launch counts zeroed just
   before and read just after (24 causal kernels a forward, no PDE kernel),
   ms per forward, peak GiB and a profiler breakdown, which must show the
   bf16 route's causal_tc kernel and not the fp32 route's; its logits held
   against the plain ``causal_stream`` path on the same weights in bf16 (5e-2
   of max |logit|); then one forward in fp32 compute, a counted window of
   its own (24 launches) traced on the device (its ms; ``route`` line:
   ``causal_tf32_kernel``, never ``causal_tc_kernel``), held against the
   plain path in fp32 (1e-3);
11. answering requests: 4 ``TokenStream`` prompts of 1,024-2,048 tokens,
   right-padded to one 2,048 bucket with ``lengths``, through ``prefill`` and
   64 greedy ``decode_step``s in bf16 (ms per prefill, ms per decode step,
   tokens/s; launch counts zeroed before and read after) and a profiler
   breakdown of one decode step (kernels launched, device busy); then in fp32
   compute (TF32 off), each step's logits against ``Model.forward`` (the
   kernel path) on the request's prompt and the tokens generated so far,
   within 1e-3 of max |logit|, with the same greedy tokens; the bf16 run's
   difference is printed;
11b. ``train flare-lm``: ``Trainer.fit`` of ``get_model(flare_lm)`` at full
   width and depth (2,609,498,112 parameters drawn anew from seed 0) on
   ``TokenStream`` batches at train_4k's T=4,096, its global batch of 256
   cut to 4, 4 microbatches of 1 (``cfg.microbatch``), 4 steps, bf16
   compute, fp32 parameters, remat "full", train plan
   ``causal_stream(chunk_size=1024)``. Checks, each raising: (1) step 0's
   first microbatch's logits on the training route (``lm_forward`` as
   ``Model.loss`` runs it, without autograd) against those of
   ``Model.forward`` under ``causal_pallas`` (the causal kernel, asserted
   from the profiler's names) within 5e-2 of max |logit|, the training
   route with the last 1,024 tokens' mixer output dropped in every layer
   rejected; (2) layer 0's mixer gradients dq, dk, dv on the model's own
   operands at T=4,096 through the train plan, bf16 and fp32, against fp64
   autograd through the same function (2e-2 and 1e-4 of max |g|), the fp64
   gradients with the last 1,024-token chunk left out of the loss rejected;
   (3) remat "full" against "none" on 2 layers at full width, B=1, T=4,096:
   the same loss and gradients (1e-6 relative; equal expected); (4) finite
   losses and grad norms at every step, no kernel launched in the fit (a
   counted window) while the plain mixer ran twice a layer and microbatch
   (forward and recomputation), and the final checkpoint read back through
   ``CheckpointManager`` in the JAX LM's stacked layout (``layers/...``,
   leading dim 24), every parameter equal. Prints ms per step (median of
   steps 2-4), tokens/s, model FLOP/s over the bf16 peak (6 x params x
   tokens, the recomputation left out), peak GiB, a profiler breakdown of
   the fit's step 4 and the phase's seconds by part;
12. ``serve qwen2-1.5b``: ``get_model(qwen2_1_5b)`` at full width and depth
   (28 layers, 1.54B parameters) from seed 0, bf16 compute. The paged
   kernel on layer 0's fp32 query and the pool's bf16 pages after the first
   decode step (captured from the wrapper's first call), against fp64 a
   head at a time with a dropped-page rejection, and its times (the kernel,
   its byte bound, the plain version, one SDPA over the gathered view).
   Then 16 seeded requests (prompts of 256-2,048 tokens, longest first;
   64-128 new tokens) through ``ServeEngine`` (8 slots, capacity 4,096,
   blocks of 16, a 16,384-token pool) three times: the dense pool, the
   paged pool's gather route and its kernel route. Each prints prefill ms a
   request, decode ms a step, tokens/s, the resolved decode backend, the
   paged launches a step (28 on the kernel route, 0 on the others,
   asserted), ``sample_host_syncs`` (0), the pool's stats (every block
   returned), page waits (admission must wait for pages at least once),
   peak GiB and a profiler breakdown of one decode step (device busy, the
   paged kernel's share). bf16: the first token that differs from the dense
   pool's is printed, first-step logits held at 5e-2 of max |logit|. Then
   4 requests in fp32 compute on the three routes: greedy tokens equal,
   first-step logits within 1e-3. Last, int8 and fp8 pools: first-step
   logits against the dense pool within the JAX package's envelope
   (|diff| <= 0.15 + 0.05 |ref|);
12b. ``serve prefix``: the same qwen2 and engine with the prefix cache, the
   paged kernel route (alone: ``scripts/torch_serve_prefix.py``). A seeded
   1,792-token template (112 blocks), pinned first with ``pin_prefix``, and
   16 requests (0: the template; i: the template and tail i % 4 of 64-448
   tokens), 64 new tokens each, with the cache off and on in bf16: prefill
   ms a request (cold and hit apart), decode ms a step, tokens/s, p50/p99
   latency, page waits, the peaks of resident requests and shared pages,
   COW copies, the hit rate and the paged launches (28 a step, counts
   zeroed before and read after each run; the cache-on run's go into the
   kernels line). Checks: the cache-on run's resident peak above the
   cache-off run's; every hit's first-token logits within 5e-2 of max
   |logit| of the cold run's (the first differing greedy token printed); a
   control, one hit's first shared page pointed at another live block,
   must exceed that limit; ``check_invariants`` with external references
   after every step of every run, and after ``release_pins`` and the drain
   no reference left; the cache-off run again with ``coalesce_prefill``
   (coalesced prefills > 0, first-token logits within 5e-2 of the solo
   run's); the cache-on run again with a ``Tracer`` and one expiring
   request (the Chrome JSON, written to a temporary file, holds every
   phase; the tokens unchanged; one ``serve.replay`` scope and none of the
   step's own in a torch.profiler trace of one replayed decode step), and
   on the eager step, the graph route's oracle (28
   ``kernels.paged_attention`` scopes, one ``serve.decode`` and one
   ``serve.sample`` in one decode step's trace); in fp32 compute (a 512-token template, 4 requests, 24
   new tokens) the cache on against off (greedy tokens printed, the hits'
   first-token logits against the same suffix prefill run outside the
   engine within 1e-3), and traced (the same tokens and host syncs). The
   cold and hit prefills of the control run are profiled;
13. ``flash``: the flash kernels on the same qwen2's layer 0 rope'd q and
   unexpanded k, v (12 query heads over 2 KV heads) at B=1, T=32,768
   (prefill_32k's length; its batch of 32 cut to 1): widened to fp32 (the
   TF32 tensor cores) against the plain version in fp64, a head and 4,096 queries
   at a time, at 1e-5 of max |plain|, which must reject the fp64 plain
   version with the 64-key tile at T/2 left out; bf16 as the model runs it
   (the tensor cores, the route asserted) against the plain version at
   1e-2, and against the fp64 plain version beyond bf16's output rounding
   (max(|o - plain| - 2**-8 |plain|) at 1e-5 of max |plain|), which must
   reject the same lost tile rounded to bf16. Times of the wgmma kernel
   and the ``bf16_mma`` kernel forced onto the same operands, in turns
   (bf16_mma, wgmma, wgmma, bf16_mma), the two bounds (two products; with
   the split P's third), the plain version (a head at a time),
   ``attn_sdpa``'s chunked route and ``F.scaled_dot_product_attention``
   (the yardstick); the fp32 route's time beside its bound, the floors of
   its design (split products, exps), its plain version and SDPA; the
   ``bf16_mma`` route on a call ``flash_route`` itself sends off TMA
   (random operands of the same geometry at D=100), its time, SDPA's where
   a backend takes it, and its bound. Then
   ``lm_prefill(impl="pallas")`` at B=1, T=32,768 (capacity 32,768; launch
   counts zeroed before and read after: 28 flash launches, all on the
   tensor cores), ms, peak GiB, a profiler breakdown (``route`` line:
   ``flash_tc_kernel``), last-token logits against ``impl="chunked"``
   within 5e-2 of max |logit|; ``lm_forward(impl="pallas")`` in fp32
   compute at B=2, T=4,096 (28 launches on the fp32 route) against
   ``impl="xla"``, all logits within 1e-3, and a profiler breakdown of it
   (``route`` line: ``flash_tf32_kernel``, no other flash kernel); 8
   greedy decode steps after a pallas and an xla prefill in fp32
   (right-padded lengths 4,096 / 3,001): the same tokens;
13b. ``train qwen2-1.5b``: as phase 11b for ``get_model(qwen2_1_5b)``
   (1,543,910,912 parameters, leading dim 28), which trains on
   ``attn_sdpa``'s ``chunked`` route (``"auto"`` at T=4,096); check (1)
   against ``lm_forward(impl="pallas")`` (the tensor-core flash kernel),
   check (2) on layer 0's rope'd q and unexpanded k, v through the chunked
   route (its scores cast to fp32, as the function does);
14. ``phi3-mini-3.8b`` at full width and depth (32 layers, 3.82B
   parameters; the seconds to draw them printed): the flash kernel at
   D=96 on layer 0's q, k, v for the prefill's tokens (B=2, H=32, T=4,096),
   held as in phase 13; ``lm_prefill(impl="pallas")`` at B=2, T=4,096 with
   right-padded lengths in bf16 (32 tensor-core launches; ms, peak GiB, a
   profiler breakdown) against ``impl="xla"`` (5e-2), and in fp32 (1e-3)
   with 8 greedy decode steps after each prefill: the same tokens; then
   served from the paged pool in fp32 compute (the same weights): the paged
   kernel at D=96 on layer 0's decode read against fp64 with a
   dropped-page rejection and its times, and 4 requests (prompts of
   256-1,024 tokens, 32 new tokens each) through ``ServeEngine``'s dense
   pool and the paged kernel route (32 paged launches a decode step
   asserted; ms a decode step, peak GiB): the greedy tokens equal;
15. ``serve deepseek-v2-lite-16b`` (``mla_phase``; alone:
   ``scripts/torch_serve_mla.py``): ``get_model(deepseek_v2_lite_16b)`` at
   full width and depth (27 layers, d_model 2,048, 16 MLA heads, 64 routed
   experts top-6 and 2 shared, the first layer dense, vocab 102,400), its
   weights drawn on the card from a CUDA generator seeded with 0 (the
   parameter count, 13-18 B asserted, and the seconds printed). (a) The
   paged kernel's MLA read (G=16, D=512, D2=64, one page head, the latents
   both K and V) on random operands, fp32 q over bf16, int8 and fp8 pages
   (``paged_mla_tc_kernel``, bf16 MMAs) and fp32 pages
   (``paged_mla_tf32_kernel``, TF32 MMAs with every operand in two parts,
   which no serving route reaches: the pool keeps bf16 latents whatever the
   compute dtype), against the plain version in fp64 at 1e-5 of max
   |plain|, which must reject the plain version with one page of the
   longest lane left out; a lane of length 0 exactly 0; the times of each
   page dtype's read beside the bound (bytes over 3.35 TB/s, or the
   fewest tensor-core products exact to fp32 q at their peak: three TF32
   products a product for fp32 pages, q in three bf16 parts and P in two
   for the others), the floors of its instance's design (bytes; its split
   products at the bf16 peak, or at the TF32 peak and ``mma.sync``'s
   measured TF32 rate), the plain version and one SDPA over the gathered
   view. (b) The same on layer 0's own decode operands after a
   real prefill (int8 / fp8 by quantizing its bf16 pages, fp32 by widening
   them). (c) 16 requests
   (prompts of 256-2,048 tokens, 32 new tokens) through ``ServeEngine``
   (``SERVE``) on the dense pool and the kernel route in bf16 (decode ms a
   step, tokens/s, prefill ms a request, p50/p99, peak GiB; 27 paged
   launches a step asserted), then 4 requests of 24 new tokens in fp32
   compute on the dense pool, the gather route and the kernel route:
   greedy tokens equal, and a profiled fp32 kernel-route decode step's
   ``route`` line names ``paged_mla_tc_kernel`` (fp32 q over bf16 pages),
   not the fp32-pages instance (a replayed step's kernels, as the bf16
   kernel route's profiled step's); with
   all 8 slots busy (prompts cut to 256 tokens), 27
   ``kernels.paged_attention`` scopes in a trace of one eager kernel-route
   decode step and a profiler breakdown of the next (``route`` line:
   ``paged_mla_tc_kernel``, not the fp32-pages instance); the MoE layers'
   expert-weight casts timed;
16. ``serve minicpm3-4b``: the same for ``get_model(minicpm3_4b)`` (62
   layers, d_model 2,560, 40 MLA heads with q-LoRA; 3.5-5.0 B asserted;
   the read at G=40, D=256, D2=32; 62 launches and scopes a step), then its
   prefix cache in bf16: a pinned 512-token template and 4 requests sharing
   it, cache off and on, the hits' first-token logits within 5e-2 of max
   |logit| of the cold run's, a control (one hit's first shared page
   pointed at another live block) that must exceed it;
16a. ``serve rwkv6-3b`` (``rwkv_phase``): ``get_model(rwkv6_3b)`` at full
   width and depth (32 layers, d_model 2,560, 40 heads of 64,
   3,099,863,040 parameters asserted), its weights drawn on the card.
   Layer 0's chunked WKV (fp32, the factored form, 64-token chunks) on the
   WKV operands the model gives it for a 1,024-token prompt in bf16
   compute, against the scan in fp64 on the same values: y and the final
   state within 1e-5 of their largest value; the chunked form run a chunk
   at a time from a zero state (the inter-chunk term dropped) must fail
   it. Then 8 requests (prompts of 512-2,048 tokens, 32 new tokens each)
   through ``ServeEngine``'s dense pool in bf16 by graph replay and on the
   eager step: greedy tokens equal; decode ms a step (graph and eager),
   tokens/s, peak GiB. RWKV-6 runs no kernel;
16b'. ``serve zamba2-7b`` (``zamba_phase``): ``get_model(zamba2_7b)`` at
   full width and depth (81 layers: 13 groups of 5 Mamba2 layers and one
   invocation of the shared attention block, 32 heads / 32 KV heads of
   112, LoRA rank 128, then 3 Mamba2 layers; 5,829,438,784 parameters
   asserted), drawn on the card. The flash kernels at D=112 on the first
   invocation's rope'd q, k, v for a 4,096-token prompt, held as in phase
   13 and timed beside their bounds, plain versions and SDPA;
   ``zamba_prefill(impl="pallas")`` of that prompt in bf16 (a counted
   window: 13 tensor-core launches; a profiler breakdown naming
   ``flash_tc_kernel``), each of its 13 launches (captured in a second
   run) held beyond bf16's output rounding against ``attn_sdpa``'s chunked
   route in fp64 on its own operands, which must reject a lost 64-key
   tile; the bf16 logits against ``impl="chunked"`` printed, not held (the
   random-weight network amplifies a difference about 1,000x over its 13
   groups); in fp32 compute the same prefill (13 launches on the fp32
   route) against ``impl="chunked"`` within 1e-3 of max |logit|. Then in
   fp32 compute: "auto" must pick the paged kernel route; the
   paged kernel at D=112 on the first invocation's decode read against
   fp64 with a dropped-page rejection, and its times; the 8 requests
   through the dense pool, the gather route and the kernel route by graph
   replay (13 paged launches a decode step asserted), greedy tokens equal,
   and the kernel route against its eager oracle;
16c. ``seamless-m4t-large-v2`` (``seamless_phase``): the encoder-decoder
   at full width and depth, drawn on the card, the attention encoder
   (24 + 24 layers, 2,035,232,768 parameters asserted) and then the FLARE
   encoder (2,217,881,600; infer plan ``packed``), each freed before the
   next. B=2 sources of 4,096 standard normal frames (the stubbed speech
   frontend) and a 128-token target prefix (capacity 160). The bf16
   prefill on the kernel route (``encdec_prefill(impl="pallas")`` with the
   model's plan; a counted window: 72 tensor-core flash launches for the
   attention encoder, 24 per attention; 24 fused FLARE forwards and 48
   flash launches for the FLARE encoder; layer 0's flash calls captured
   from it), each of layer 0's flash calls (the encoder's at 4,096/4,096
   without a mask, the decoder's causal 128/128, the cross-attention's
   128/4,096) held as in phase 13 (a lost 64-key tile at Skv/2 rejected)
   and timed beside its bound, plain version and SDPA; the FLARE kernels
   (encode, decode, fused forward) on encoder layer 0's own q, k, v (H=16,
   M=256, N=4,096, D=64) in bf16 and fp32 against fp64 (a lost 256-token
   or 64-latent tile rejected) and timed; a profiler breakdown (``route``
   lines: ``flash_tc_kernel``, and ``encode_tc_kernel`` /
   ``decode_tc_kernel`` for FLARE); the plain route (``chunked``, the
   ``sdpa`` policy; no launch asserted); the bf16 last-token logits within
   5e-2 of max |logit| of the plain route's (or, where the network
   amplifies rounding past that, the encoder memory after layer 0 and
   after the encoder within 2e-2); 32 greedy decode steps (eager ms a
   step, no launch asserted) and a profiled step; the FLARE encoder under
   the ``pallas`` policy (24 encodes, 24 decodes, 48 flash launches); then
   in fp32 compute both routes (72, or 24 + 48, launches on the fp32
   route, ``flash_tf32_kernel``), the logits within 1e-3, a control (layer
   0's encoder mixer output zeroed on the last 1,024 frames) that must
   exceed it, and 32 greedy tokens equal on both routes;
16d. ``train seamless-m4t-large-v2`` (``train_seamless_phase``): the FLARE
   encoder (then the attention encoder, each freed before the next) drawn
   on the card, bf16 compute, fp32 parameters, remat "full", the train plan
   asserted ``packed``; the launcher's batches (B=2: 4,096 standard normal
   source frames and 4,096 ``TokenStream`` tokens a sequence, microbatches
   of 1). (a) Row 4 on encoder layer 0's own q, k, v for that batch
   (B=2, H=16, M=256, N=4,096, D=64) and a seeded dy: bf16 beyond its output
   rounding and fp32 at 1e-5 of max |plain| against the plain backward in
   fp64, dk and dv rejecting a dZ that lost a 64-token tile and dq one that
   lost 64 latents; its times beside the bound (bf16 FLOP at the bf16 peak or
   bytes), its plain version, autograd through two SDPA calls, and ptxas's
   registers and spills. (b) One microbatch's whole step in fp32 compute
   under ``packed`` (48 fused forwards, 24 backwards) against ``sdpa`` on the
   same weights: the loss and every gradient leaf within 1e-4 of the tree's
   max |g|, which the step with encoder layer 0's mixer output zeroed on the
   last 1,024 frames must fail. (c) The bf16 step's loss against
   ``sdpa``'s within 5e-2 (its gradients' distance printed). Then 3 steps of
   ``Trainer.fit`` (no checkpoint written), the launch counters read at each
   microbatch: 48 fused forwards (forward and recomputation) and 24 fused
   backwards, and nothing else, a microbatch; ms a step, tokens/s, model
   FLOP/s over the bf16 peak, AdamW ms (CUDA events in the step), peak GiB,
   a profiled step after the fit (its busy share; ``route``: the bf16 D=64
   ``dz``/``dkv``/``dq`` and forward kernels, no flash kernel). The
   attention encoder: the same fit, no port kernel launched, its ms and
   peak; under 0.2 GiB left allocated after the phase;
16e. ``train rwkv6-3b`` (``train_rwkv_phase``): drawn on the card, the
   launcher's batches at B=4, T=4,096 (microbatches of 1). Autograd through
   layer 0's chunked WKV (fp32) on the model's own operands for the first
   1,024 tokens against autograd through the scan in fp64: dr, dk, dv, dw,
   du within 1e-4 of each max |g|, the chunks run alone (the inter-chunk
   term dropped) rejected. 3 steps of ``Trainer.fit`` (no kernel launched in
   any microbatch), the first loss within a tenth of ln(vocab), the figures
   and the profiled step of 16d; under 0.2 GiB left allocated;
16b. serving by graph replay, in every serving phase above (11, 12, 12b,
   14, 15, 16, 16a, 16b'): each engine runs ``ServeEngine.warmup`` first (its prefill
   buckets, then the decode step captured as one CUDA graph), and must
   count one decode build after it and still one after serving; its
   replayed steps' paged launches are layers x steps. Each configuration
   (flare_lm's 4 requests through the dense pool in bf16 and fp32; qwen2's
   kernel route in bf16, its three routes in fp32, its int8 and fp8 pools
   at the requests' full new tokens;
   phi3's kernel route; the prefix cache on in bf16 and fp32; each MLA
   model's kernel route in bf16 and its three routes in fp32; MiniCPM3's
   prefix cache; a bf16 oracle decodes EAGER_NEW = 16 tokens a request) keeps
   one run on the eager step (``cuda_graph=False``) as its oracle
   (``graph_held`` lines): fp32 greedy tokens equal, bf16 first-step
   logits within 5e-2 of max |logit| with the first differing token
   printed, decode ms a step, busy shares and peak GiB side by side. Then
   ``launch serve``: ``python -m repro_torch.launch.serve --arch
   qwen2_1_5b ... --decode-backend paged --warmup --max-decode-compiles 0``
   at full size in a process of its own must exit 0 with "0 while serving"
   and "host syncs/step: 0.0". A ``phase seconds`` line closes the run;
17. one JSON line of per-kernel numbers (12 kernels: the wgmma flash kernel
   is a row of its own; the flash rows and the FLARE forward's rows (1-3)
   carry their seamless-m4t records under ``seamless_m4t``; the paged kernel's row also carries its MLA
   instances' reads under ``mla_read``: each model's bf16-pages read
   (``paged_mla_tc_kernel``) with its fp32-pages read under ``fp32_pages``
   (``paged_mla_tf32_kernel``), the ``flash_attention`` row (the
   TF32 kernel's) its bf16_mma route under ``off_tma_bf16``, the causal
   kernel's row (bf16) its fp32 route under ``fp32``; the paged row and
   both flash rows their reads at Zamba2's D=112 under ``zamba_d112``;
   the fused backward's row its bf16 and fp32 records at seamless-m4t's
   shape under ``seamless_m4t``),
   then the card's name and power limit, then ``{"ok": true, "device":
   ...}`` as the last line.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth. Every bound is against these.
PEAK_FP32 = 67e12
PEAK_BW = 3.35e12
PEAK_TF32 = 495e12   # tensor cores, dense
# mma.sync m16n8k8 TF32 as measured on the H100 (scripts/torch_mma_rate.py):
# the rate the mma.sync designs' split products are also held to
MMA_SYNC_TF32 = 316e12
# the backward kernel's exps and products a (latent, token) pair: W in pass
# a, A and W in b and in c; S and dZ, S, v dZ^T, dy Z^T, dk and dv, S,
# dZ v^T, Z dy^T and dq (csrc/flare_bwd.cu)
BWD_EXPS, BWD_PRODUCTS = 5, 11
# the forward kernels' (csrc/flare.cu): P in the encode, W in the decode; S
# and P v, S^T and W Z. The encode and the decode alone take half of each.
FWD_EXPS, FWD_PRODUCTS = 2, 4

SEED = 0
# bf16 and ragged edges, on random operands (the model itself runs fp32)
SMALL = {"bf16 full width": dict(b=1, h=8, m=2048, n=40000, d=8),
         "ragged": dict(b=2, h=4, m=16, n=97, d=8)}
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}   # absolute: max |kernel - plain|
# relative: max |kernel - plain| / max |plain|. A kernel that dropped one
# token tile (encode) or one latent tile (decode) must fail it: the script
# measures that on the main path's operands and raises if it would pass.
RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16's unit roundoff: rounding x to nearest moves it by at most 2**-8 |x|.
# At T=32,768 a lost 64-key tile moves o by less than that, so a bf16 output
# of the flash kernel is held beyond this rounding (Checks.hold_rounded).
BF16_U = 2.0 ** -8
# The fp32 gradients differ in scale by three orders: dq sums over all B*N
# tokens (max |dq| 676 at pde_40k), dk and dv over M latents (3.0, 0.29), and
# dv shrinks as N grows. So each has its own absolute limit on the main path,
# none looser than 1e-4 of its max |plain| at either shape (the script checks
# that too).
BWD_ATOL = {"dq": 1e-2, "dk": 1e-5, "dv": 1e-6}
# tokens per staged encode tile and latents per staged decode tile of
# csrc/flare.cu at D=8 (32 steps of 8 columns; the two-level sums' inner
# level), the tile a check leaves out; the backward's checks leave out as many
TILE = 256
PATH_TOL = 1e-3   # the kernel paths against the plain path after 8 blocks, abs and rel
# Training, the kernel path against the plain path (relative, per step): the
# loss and grad_norm 1e-4, fp32 sums in another order through 8 blocks and
# their backward; the parameters after 5 steps within 5% of the peak lr:
# Adam divides each gradient by its own RMS, so a difference in a small
# gradient comes through as a fraction of a whole step of size lr.
TRAIN_TOL = 1e-4
PARAM_TOL_LR = 0.05
TRAIN_STEPS, TRAIN_LR = 20, 1e-3
SOURCES = {name: "src/repro_torch/csrc/flare.cu"
           for name in ("flare_encode", "flare_decode", "flare_fused_fwd")}
SOURCES["flare_fused_bwd"] = "src/repro_torch/csrc/flare_bwd.cu"
SOURCES["flare_causal_chunk"] = "src/repro_torch/csrc/flare_causal.cu"
SOURCES["paged_attention"] = "src/repro_torch/csrc/paged_attention.cu"
SOURCES["flash_attention"] = "src/repro_torch/csrc/flash_attention.cu"
SOURCES["flash_attention_tc"] = "src/repro_torch/csrc/flash_attention_sm90.cu"
SOURCES.update({"flare_enc_stats": "src/repro_torch/csrc/flare.cu",
                "flare_shard_decode": "src/repro_torch/csrc/flare.cu",
                "flare_shard_dz": "src/repro_torch/csrc/flare_bwd.cu",
                "flare_shard_grads": "src/repro_torch/csrc/flare_bwd.cu"})
REPLACES = {
    "flare_encode": "src/repro/kernels/flare.py:48",
    "flare_decode": "src/repro/kernels/flare.py:150",
    "flare_fused_fwd": "src/repro/kernels/flare_packed.py:162",
    "flare_fused_bwd": "src/repro/kernels/flare_packed.py:266",
    "flare_causal_chunk": "src/repro/kernels/flare_causal.py:41",
    "paged_attention": "src/repro/kernels/paged_attention.py:64",
    "flash_attention": "src/repro/kernels/attention.py:26",
    "flash_attention_tc": "src/repro/kernels/attention.py:26",
    "flare_enc_stats": "src/repro/kernels/flare_packed_shard.py:105",
    "flare_shard_decode": "src/repro/kernels/flare_packed_shard.py:180",
    "flare_shard_dz": "src/repro/kernels/flare_packed_shard.py:217",
    "flare_shard_grads": "src/repro/kernels/flare_packed_shard.py:266",
}
PDE_KERNELS = ("flare_encode", "flare_decode", "flare_fused_fwd", "flare_fused_bwd")
# the causal LM (flare_lm): random operands at its width and a ragged shape
CAUSAL_SMALL = {"bf16 full width": dict(b=1, h=16, m=512, n=8192, d=128),
                "ragged": dict(b=2, h=4, m=16, n=97, d=8)}
# the causal kernel at head dims it runs at a padded width (24 at 32, 40 at
# 64, phi3's 96 at 128), fp32 against the plain version in fp64
CAUSAL_WIDE = {24: dict(b=1, h=2, m=70, n=300, d=24), 40: dict(b=2, h=2, m=64, n=500, d=40),
               96: dict(b=1, h=4, m=128, n=1000, d=96)}
PEAK_BF16 = 989e12   # H100 SXM bf16 tensor cores, dense: the peak for bf16 operands
# flare_lm logits, a kernel path against a plain path on the same weights,
# over max |logit|: fp32 sums in another order through 24 layers (1e-3, as
# PATH_TOL); bf16 rounds each layer's mixer output to 8 bits, and a one-ulp
# flip (3.9e-3) can differ between the two paths in every layer (5e-2)
LM_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
REQUESTS, BUCKET, DECODE_STEPS = 4, 2048, 64
GRADS = ("dq", "dk", "dv")
# the paged-attention kernel on random operands: query rows G (1: a decode
# read, 6: qwen2's query heads per KV head, 2048: the FLARE encode) by head
# dim, every page dtype, with and without the second score term q2 k2
PAGED_SMALL = [(g, d) for g in (1, 6, 2048) for d in (8, 24, 96, 128)]
PAGE_DTYPES = ("float32", "bfloat16", "int8", "fp8")
PAGED_SCALE = 0.7
# serving qwen2-1.5b (full width and depth, random weights): 16 requests, the
# longest prompts first, so the first wave stakes more pages than the pool
# holds and admission waits for pages, not slots
SERVE = dict(slots=8, capacity=4096, block_size=16, pool_tokens=16384)
SERVE_REQUESTS, PROMPT_LENS, NEW_TOKENS = 16, (256, 2048), (64, 128)
SERVE32_REQUESTS, SERVE32_NEW = 4, 24      # fp32 compute: greedy tokens held across routes
# new tokens a request of a bf16 configuration's eager oracle (the graph
# route's runs keep theirs; the two are compared over the oracle's tokens)
EAGER_NEW = 16
# serving with the prefix cache, the same engine: a 1,792-token template
# (112 blocks), 16 requests (0: the template; i: the template and tail
# i % 4 of 64-448 tokens), 64 new tokens each. Cold, a request stakes its
# bucket's 128 or 256 of the pool's 1,024 pages, so fewer than 8 are
# resident; a hit stakes 5-32 pages beside the 112 pinned ones. fp32: a
# 512-token template, 4 requests, 24 new tokens
PREFIX_TEMPLATE, PREFIX_REQUESTS, PREFIX_NEW = 1792, 16, 64
PREFIX_TAILS, PREFIX_VARIANTS = (64, 448), 4
PREFIX32_TEMPLATE, PREFIX32_REQUESTS, PREFIX32_NEW = 512, 4, 24
ROUTES = {"dense": dict(pool_tokens=None), "gather": dict(decode_backend="gather"),
          "paged": dict(decode_backend="paged")}
# first-step logits of a route against the dense pool's, over max |logit|:
# fp32 sums in another order (1e-3, as LM_TOL); bf16 rounds every layer's
# attention output and a one-ulp flip can differ between routes (5e-2)
ROUTE_TOL = LM_TOL
# int8 / fp8 pools against the dense pool, elementwise |a - b| <= atol + rtol
# |b|: the JAX package's envelope (tests/test_paged_pool.py), kept at full
# width, where the logits' scale is that of the smoke configs' (a few units)
QUANT_ENVELOPE = dict(atol=0.15, rtol=0.05)
# qwen2-1.5b's layers and parameters (the tied embedding padded to 152,064 rows)
QWEN2_SIZE = (28, 1_543_910_912)
# flare_lm's layers and parameters
FLARE_LM_SIZE = (24, 2_609_498_112)
# training the LMs: train_4k's length, its global batch of 256 cut to 4, 4 steps
LM_TRAIN_T, LM_TRAIN_B, LM_TRAIN_STEPS = 4096, 4, 4
# layer 0's mixer gradients through the training route against fp64 autograd
# through the same function, over max |g|: bf16 rounds q, k, v and y to 8
# bits (read at up to 7.6e-3 on qwen2's operands, 3.7e-3 on flare_lm's;
# 2e-2); fp32 sums in another order (1e-4). The fp64 gradients with the
# last chunk's tokens (flare_lm's 1,024-token chunk) left out of the loss
# must fail the bf16 limit (read at 6.8e-2 on qwen2's dq, 2.7e-2 on its dk,
# 0.41-0.51 on flare_lm's)
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LOST_CHUNK = 1024
# step 0's first microbatch through the training route (lm_forward as
# Model.loss runs it, without autograd) against the served forward kernels'
# logits, over max |logit|: LM_TOL's bf16 limit; the training route with the
# last LOST_CHUNK tokens' mixer output dropped in every layer must fail it
# remat "full" against "none" at full width on this many layers: the same
# kernels recomputed on the same inputs, so equal is expected
REMAT_LAYERS, REMAT_TOL = 2, 1e-6
# the flash kernel on random operands: head dims, (Sq, Skv) ragged and Sq > Skv
# (128 over 64: with a window of 24, rows >= 87 see no key), and masks
FLASH_D = (8, 16, 24, 32, 64, 96, 128)
FLASH_H, FLASH_HKV = 6, (1, 2, 6)   # query heads, and KV heads: MQA, GQA 3:1, MHA
FLASH_LENGTHS = ((97, 97), (300, 300), (128, 64))
FLASH_MASKS = {"causal": dict(causal=True, window=None),
               "full": dict(causal=False, window=None),
               "causal+window 24": dict(causal=True, window=24)}
FLASH_QCHUNK = 4096    # query rows a block of the plain version at T=32,768
# bf16 calls flash_route sends off TMA (the bf16_mma route), as random
# operands [B, S, H, D] at B=2, S=300, 6 query heads over 2: D=100 (200-byte
# rows: 8-byte copies) and D=128 in memory 8 bytes past a 16-byte boundary
FLASH_OFF_TMA = {"D=100": 100, "D=128 base off by 8 bytes": 128}
# the bf16_mma route timed at qwen2's layer-0 geometry with D=100
OFF_TMA_D = 100
# the dense family's prefill through the flash kernel: qwen2 at B=1,
# T=32,768 (prefill_32k's batch of 32 cut to 1) and in fp32 at B=2, T=4,096
# (train_4k's length); phi3 at B=2, T=4,096 (its published 4k context) with
# right-padded lengths; greedy decode steps after each prefill
DENSE_B, DENSE_T, DENSE_LENGTHS, DENSE_DECODE = 2, 4096, (4096, 3001), 8
# phi3-mini-3.8b's layers and parameters (the untied head over 32,256 rows)
PHI3_SIZE = (32, 3_822_259_200)
# phi3 served from the paged pool through the kernel (D=96) against the
# dense pool, fp32 compute: 4 requests of 256-1,024 prompt tokens, 32 new each
PHI3_SERVE = dict(slots=4, capacity=1088, block_size=16, pool_tokens=4352)
PHI3_REQUESTS, PHI3_PROMPTS, PHI3_NEW = 4, (256, 1024), 32
# the MLA models (random weights drawn on the card): parameter ranges of
# tests/test_models_smoke.py; the MLA read on random operands (8 lanes: an
# empty one, a partial page, six of about 2,000 tokens) over bf16, int8 and
# fp8 pages (the bf16 tensor-core instance) and fp32 pages (the TF32 one,
# which only a direct call with fp32 pages reaches); 16 requests
# (SERVE_REQUESTS, PROMPT_LENS) of MLA_NEW new tokens
# on the dense and kernel routes in bf16, MLA_SERVE32_* on the three routes
# in fp32 compute; MiniCPM3's
# prefix cache: a 512-token template and 4 requests sharing it
DEEPSEEK_PARAMS, MINICPM3_PARAMS = (13e9, 18e9), (3.5e9, 5.0e9)
MLA_LENGTHS = (0, 17, 1985, 1993, 2000, 2017, 2031, 2048)
MLA_PAGE_DTYPES = ("bfloat16", "int8", "fp8", "float32")
MLA_P_PARTS = 2   # bf16 parts of the weights in the tensor-core read's value product
MLA_NEW = 32   # new tokens a request
MLA_SERVE32_REQUESTS, MLA_SERVE32_NEW = 4, 24
MLA_PREFIX_TEMPLATE, MLA_PREFIX_REQUESTS, MLA_PREFIX_NEW = 512, 4, 16
# the ssm and hybrid families at full width and depth (random weights drawn
# on the card): RWKV-6 3B's and Zamba2-7B's (layers, parameters); 8 requests
# of 512-2,048 prompt tokens, RECURRENT_NEW new tokens each, on SERVE's
# engine (8 slots, capacity 4,096). One RWKV-6 layer's chunked WKV on a
# WKV_T-token prompt against the scan in fp64, over max |y| (fp32 sums in
# another order); the chunked form with the inter-chunk term dropped must
# fail it. Zamba2's flash check and pallas prefill on one ZAMBA_PREFILL_T
# prompt
RWKV_SIZE, ZAMBA_SIZE = (32, 3_099_863_040), (81, 5_829_438_784)
RECURRENT_REQUESTS, RECURRENT_PROMPTS, RECURRENT_NEW = 8, (512, 2048), 32
WKV_T, WKV_TOL = 1024, 1e-5
ZAMBA_PREFILL_T = 4096
# the encoder-decoder seamless-m4t-large-v2 at full width and depth (random
# weights drawn on the card), each encoder variant's (layers, encoder
# layers, parameters); B=2 source sequences of SEAMLESS_SRC frames (standard
# normal embeddings, the stubbed speech frontend), a SEAMLESS_T-token
# target prefix in a cache of SEAMLESS_CAP rows, SEAMLESS_NEW greedy decode
# steps. The fp32 logits of the kernel route against the plain route at
# LM_TOL; the control zeroes layer 0's encoder mixer output on the last
# SEAMLESS_LOST source frames. bf16 logits at LM_TOL's 5e-2 where they
# hold, else the encoder memory after layer 0 and after the encoder at
# SEAMLESS_MEM_TOL of max |plain|. The FLARE decode's lost-tile control
# leaves out FLARE_LATENT_TILE latents (the encode's: TILE tokens)
SEAMLESS_SIZES = {"attn": (24, 24, 2_035_232_768), "flare": (24, 24, 2_217_881_600)}
SEAMLESS_B, SEAMLESS_SRC, SEAMLESS_T, SEAMLESS_CAP, SEAMLESS_NEW = 2, 4096, 128, 160, 32
SEAMLESS_LOST, SEAMLESS_MEM_TOL, FLARE_LATENT_TILE = 1024, 2e-2, 64
# training seamless-m4t-large-v2 (both encoders) and rwkv6-3b at full width
# and depth, FAMILY_STEPS steps of Trainer.fit on the launcher's batches at
# T=LM_TRAIN_T (seamless: B=SEAMLESS_TRAIN_B with as many standard normal
# source frames as target tokens; rwkv6: B=LM_TRAIN_B), microbatches of
# cfg.microbatch. Row 4 on encoder layer 0's operands at the fit's batch,
# whose dk and dv must reject a dZ that lost TOKEN_TILE tokens (dq: one that
# lost FLARE_LATENT_TILE latents). The whole fp32 step, packed against sdpa:
# the loss and every gradient leaf within STEP_TOL of the tree's max |g|
# (TRAIN_TOL: fp32 sums in another order through 48 layers and their
# backward), which a step that lost SEAMLESS_LOST frames of layer 0's mixer
# output must fail. RWKV-6's first loss within LOSS_NEAR of ln(vocab). A
# phase leaves under EMPTY_GIB allocated on the card
SEAMLESS_TRAIN_B, FAMILY_STEPS, TOKEN_TILE = 2, 3, 64
STEP_TOL, LOSS_NEAR, EMPTY_GIB = TRAIN_TOL, 0.1, 0.2
# the bf16 D=64 instances of the fused kernels, as the profiler names them
FLARE_BWD16 = tuple(f"{kind}_kernel<__nv_bfloat16, {d}" for kind, d in (
    ("dz", 64), ("dkv", 64), ("dq", 64), ("encode_tc", ""), ("decode_tc", "")))
# Algorithm 1 (core/spectral.py) on block 0's latent queries and keys at
# pde_40k: the fp32 eigenvalues against fp64's within SPECTRAL_TOL of the
# largest, which the fp64 spectrum of the keys without their last
# SPECTRAL_DROP tokens must fail
SPECTRAL_TOL, SPECTRAL_DROP = 1e-5, 1024
# the FLARE kernels at head dims beside the paper's 8, on random operands
WIDE_D = (3, 4, 6, 12, 16, 24, 32, 64)
WIDE_SHAPE = dict(b=2, h=3, m=40, n=700)
# the sharded mixer: token slices emulated on the card, and the sequence-
# parallel trainer's steps (pde_40k against the packed plan, then pde_1m);
# the sharded path against the packed path, losses and parameters (absolute;
# on one rank it runs the same kernels in the same order, so equal expected)
SHARD_SLICES, SHARDED_STEPS, SHARDED_STEPS_1M = 4, 5, 2
SHARD_TOL = 1e-4
# the Table-1 mixers at flare_pde's width (C=64, H=8, D=8, 8 blocks, M=2048:
# FLARE's latents, the Perceiver's latents, the Linformer's projected length,
# the Transolver's slices). pde_16k: Darcy at grid 128, B=8, N=16,384, the
# largest N all five take (the Linformer's learned projection has 16,384
# rows); 5 AdamW steps each (TrainConfig's defaults: weight decay on)
BASELINES = ("vanilla", "perceiver", "linformer", "transolver")
TABLE1 = dict(b=8, grid=128, steps=5)
# each baseline against the fp64 plain oracle (the plain sdpa route, fp64
# operands and weights) at B=1, N=4,096, where its scores fit: the forward
# over max |y| and every gradient over its leaf's max |g| (a key bias and
# the Perceiver's unread enc/dec ln2 and mlp, whose exact gradient is zero,
# over the tree's max |g|), at the CPU tests' fp32 limits. The oracle with
# the last LOST_CHUNK rows of one attention output zeroed (the last call:
# block 7's, the Perceiver's decode) must fail both
BASE_CHECK_GRID, BASE_FWD_TOL, BASE_GRAD_TOL = 64, 1e-5, 1e-4
# one block's forward at B=1 over N (fig. 8); the Linformer takes N <= 16,384
# and vanilla attention is not timed at 2^20 tokens (N^2 = 1.1e12 scores a head)
FIG8_N = (4096, 16384, 40000, 1 << 20)
VANILLA_MAX_N = 40000
# SDPA's memory-efficient kernels (the baselines' attention route), as the
# profiler names them, and the aten ops that launch them, as a dispatch mode
# sees them: once each way a call
MEM_EFF = ("fmha_cutlassF", "fmha_cutlassB")
MEM_EFF_OPS = ("_scaled_dot_product_efficient_attention",
               "_scaled_dot_product_efficient_attention_backward")
SOFTMAX = ("softmax_warp", "SoftMax")   # a materialised softmax: the math route's


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_init(model, seed: int = SEED):
    """``model``'s weights drawn on the card from a CUDA generator seeded
    with ``seed``: well under a second where the CPU takes 14-37 s for a
    1.5-3.8 B model (its stream differs from the CPU's)."""
    import torch

    return model.init(seed, generator=torch.Generator(device="cuda").manual_seed(seed))


def graph_ms(fn, reps: int) -> float:
    """Device ms of ``fn`` captured once in a CUDA graph and replayed: the
    time of a call whose host cost (Python checks, allocation, the launch)
    would otherwise exceed its device time and set the pace of ``cuda_ms``."""
    import torch

    fn()   # warm the allocator and the build outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


PAGED_TYPES = {"a": "i8", "f": "f32", "13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8"}


def ptxas_summary(log: str) -> list:
    """One line per FLARE kernel at D=8 (its own instance, D known at compile
    time) and at the padded width 64, causal kernel (both routes) at D=32
    and 128 and its combine at 128, paged
    kernel (decode: page dtype x rows; MLA on the tensor cores: page dtype x
    padded D, on the CUDA cores for fp32 pages: x rows a thread), the bf16
    flash kernel off TMA's route (one per padded D), the TF32
    flash kernel (fp32, one per padded D) and the wgmma flash kernel
    (one per padded D; its
    registers are those at entry, before setmaxnreg moves them to the
    consumer warpgroups): registers, shared memory, stack frame and spills,
    then ptxas's warnings (a wgmma it had to serialize, a setmaxnreg it
    ignored). Each figure is keyed
    by the function that ptxas's "Function properties" line names, since
    the parallel compile can interleave the functions' lines."""
    rows, props, frame = [], None, {}
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\w+)", line):
            props = m.group(1)
        elif props and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                       r"(\d+) bytes spill loads", line)):
            frame[props] = f"stack {m.group(1)} B, spill {m.group(2)}/{m.group(3)} B"
        elif (m := re.search(r"Used (\d+) registers(.*)", line)) and props and (
                "Li8ELb1E" in props or "Li64ELb0E" in props
                or ("causal_t" in props and re.search(r"Li(32|128)E", props))
                or ("causal_combine" in props and "Li128E" in props)
                or "paged" in props or "flash" in props):
            kind = next(k for k in ("paged_combine", "paged_decode", "paged_mla_tc",
                                    "paged_mla_tf32",
                                    "paged_encode", "causal_combine", "causal_tc",
                                    "causal_tf32", "encode_tc", "decode_tc", "combine", "dz",
                                    "dkv", "dq", "flash_tc", "flash_tf32", "flash_bf16")
                        if f"{k}_kernel" in props)
            args = props.split("_kernelI", 1)[-1]
            types = ["bf16" if t.startswith("13") else "f32"
                     for t in re.findall(r"13__nv_bfloat16|f", args.split("Li")[0])]
            if kind in ("flash_tc", "causal_tc", "flash_bf16"):
                types = ["bf16"]
            elif kind in ("flash_tf32", "causal_tf32"):
                types = ["f32"]
            width = re.search(r"Li(\d+)E", args)
            label = (f"{'/'.join(types)} D={width.group(1)}" if width and types
                     else props[:60])
            if kind == "paged_decode":   # <page dtype, query rows a block at most>
                page = args.split("Li")[0]
                label = f"{PAGED_TYPES.get(page, page)} rows<={width.group(1)}"
            elif kind == "paged_mla_tf32":   # <padded D>: fp32 pages
                label = f"f32 D<={width.group(1)}"
            elif kind == "paged_mla_tc":   # <page dtype, padded D>
                page = args.split("Li")[0]
                label = f"{PAGED_TYPES.get(page, page)} D<={width.group(1)}"
            elif kind == "paged_encode":   # <padded D, plain (no scales, scale 1)>
                label = f"D={width.group(1)} {'plain' if 'Lb1E' in args else 'scaled'}"
            elif kind in ("encode_tc", "decode_tc"):   # <.., D, exact, row tiles a warp>
                label += f" MT={re.search(r'Lb[01]ELi(\d+)E', args).group(1)}"
            elif kind.startswith("causal") and re.search(r"Lb[01]E", args):
                # the exact instance (D its own width) or the padded one
                page = args.split("Lb")[0]
                label = label if width else PAGED_TYPES.get(page, page)
                label += " exact" if "Lb1E" in args else " padded"
            rows.append(f"  {kind:<9} {label:<16} {m.group(1)} regs{m.group(2)}, "
                        f"{frame.get(props, 'no frame line')}")
    rows += [f"  {line.strip()[:160]}" for line in log.splitlines()
             if "warning" in line.lower()][:12]
    return rows


def inputs(s: dict, dtype, gen, device):
    """q [H, M, D]; k, v [B, H, N, D] as the strided views the model gives."""
    import torch

    q = torch.randn(s["h"], s["m"], s["d"], generator=gen) * s["d"] ** -0.5
    k = torch.randn(s["b"], s["n"], s["h"], s["d"], generator=gen)
    v = torch.randn(s["b"], s["n"], s["h"], s["d"], generator=gen)
    return (q.to(device, dtype), k.to(device, dtype).transpose(1, 2),
            v.to(device, dtype).transpose(1, 2))


def mixer_operands(net, x):
    """q, k, v as block 0's mixer receives them for input x: the main path's
    own operands, k and v as strided split-head views."""
    import torch

    from repro_torch.nn.modules import layernorm, resmlp

    with torch.no_grad():
        blk = net.blocks[0]
        h = layernorm(blk.ln1, resmlp(net.in_proj, x))
        q = blk.mixer.q_latent.detach()
        heads = lambda t: t.unflatten(2, (q.shape[0], -1)).transpose(1, 2)
        return q, heads(resmlp(blk.mixer.k_proj, h)), heads(resmlp(blk.mixer.v_proj, h))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def by_head(fn, q, *xs):
    """A plain version run one head at a time (its [B, M, N] scores must fit
    the card), outputs concatenated over heads."""
    import torch

    outs = [fn(q[i:i + 1], *(x[:, i:i + 1] for x in xs)) for i in range(q.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


class Checks:
    """Kernel outputs held against their plain versions; every comparison is
    printed with the plain output's scale, and a failure raises only after
    the whole phase has printed."""

    def __init__(self):
        # by kernel row, and by extra key (a route's own record within a row)
        self.failures, self.max_abs = [], collections.defaultdict(float)

    def hold(self, name, what, got, want, dtype, *, atol, record=False, dropped=None,
             fp32_plain=None, quiet=False):
        """``want``: the plain version on the same inputs, in the kernel's
        dtype or in fp64 (with ``fp32_plain`` beside it, the plain version's
        own output, where there is one). ``atol``: the absolute limit, or None for an output held
        relative to its size only. ``record``: count the error into the
        kernel's ``max_abs_err``. ``dropped``: {what was left out: the fp64
        plain version with one tile left out}, the output of a kernel that
        lost a tile; the relative limit must reject each. ``record`` may
        also be a key of its own (a route's record within a kernel's row).
        ``quiet``: print the line only on a failure. Returns the relative
        error (None where the shapes or dtypes differ)."""
        import torch

        key = str(dtype).removeprefix("torch.")
        label = f"{name} {what}"
        like = want if fp32_plain is None else fp32_plain
        # an fp64 ``want`` without a plain output beside it: got is the kernel's dtype
        like_dtype = dtype if like.dtype == torch.float64 else like.dtype
        if got.shape != like.shape or got.dtype != like_dtype:
            self.failures.append(f"{label}: {tuple(got.shape)}/{got.dtype} vs plain "
                                 f"{tuple(like.shape)}/{like.dtype}")
            return None
        err, scale = max_err(got, want), want.abs().max().item()
        rel = err / scale
        ok = math.isfinite(err) and rel <= RTOL[key] and (atol is None or err <= atol)
        line = (f"  {label:<22} max|plain| {scale:.4g}  abs err {err:.3g} (atol "
                f"{'-' if atol is None else f'{atol:g}'})  rel {rel:.3g} (rtol {RTOL[key]:g})")
        if fp32_plain is not None:
            line += f"  [fp32 plain: rel {max_err(fp32_plain, want) / scale:.3g}]"
        for left_out, drop in (dropped or {}).items():
            rel_drop = max_err(drop, want) / scale
            line += f"  {left_out} dropped: rel {rel_drop:.3g}"
            if not rel_drop > RTOL[key]:
                self.failures.append(f"{label}: rtol {RTOL[key]} would pass a kernel that "
                                     f"dropped a {left_out} (rel {rel_drop:.3g})")
        if not (quiet and ok):
            print(line + ("" if ok else "  FAILED"), flush=True)
        if not ok:
            self.failures.append(f"{label}: abs {err:.3g}, rel {rel:.3g}")
        if record:
            key = record if isinstance(record, str) else name
            self.max_abs[key] = max(self.max_abs[key], err)
        return rel

    def hold_rounded(self, name, what, got, want, *, dropped):
        """bf16 ``got`` from a kernel that computes in fp32 and rounds only
        its output, against ``want``, the plain version in fp64 on the same
        bf16-valued inputs. Rounding to nearest moves o by at most
        BF16_U |o|; what is left, max(|got - want| - BF16_U |want|) over
        max |want|, is the fp32 arithmetic's error and must be within the
        fp32 limit. ``dropped``: {what was left out: the fp64 plain version
        with it left out}; each, rounded to bf16 as such a kernel would
        return it, must be rejected."""
        import torch

        label = f"{name} {what}"
        scale = want.abs().max().item()

        def excess(o) -> float:
            return ((o.double() - want).abs() - BF16_U * want.abs()).max().item() / scale

        rel = excess(got)
        ok = got.dtype == torch.bfloat16 and math.isfinite(rel) and rel <= RTOL["float32"]
        line = (f"  {label:<22} max|plain| {scale:.4g}  error beyond bf16 rounding: rel "
                f"{rel:.3g} (rtol {RTOL['float32']:g})")
        for left_out, drop in dropped.items():
            rel_drop = excess(drop.to(torch.bfloat16))
            line += f"  {left_out} dropped: rel {rel_drop:.3g}"
            if not rel_drop > RTOL["float32"]:
                self.failures.append(f"{label}: rtol {RTOL['float32']} would pass a kernel that "
                                     f"dropped a {left_out} (rel {rel_drop:.3g})")
        print(line + ("" if ok else "  FAILED"), flush=True)
        if not ok:
            self.failures.append(f"{label}: {got.dtype}, rel {rel:.3g} beyond bf16 rounding")

    def raise_failures(self, phase):
        if self.failures:
            raise AssertionError(f"{phase}: " + "; ".join(self.failures))


def check_small(checks: Checks, device) -> None:
    """Every kernel against its plain version on random operands: bf16 at
    the full width, and ragged edges (M=16, N=97) in both dtypes."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd

    gen = torch.Generator().manual_seed(SEED)
    for shape_name, s in SMALL.items():
        for dtype in ((torch.bfloat16,) if shape_name.startswith("bf16")
                      else (torch.float32, torch.bfloat16)):
            q, k, v = inputs(s, dtype, gen, device)
            print(f"kernels {shape_name} {s} {dtype}:", flush=True)
            atol, f32 = ATOL[str(dtype).removeprefix("torch.")], dtype == torch.float32
            z_ref = ref.flare_encode_ref(q, k, v)
            checks.hold("flare_encode", "z", flare_encode(q, k, v), z_ref, dtype, atol=atol,
                        record=f32)
            checks.hold("flare_decode", "y", flare_decode(q, k, z_ref),
                        ref.flare_decode_ref(q, k, z_ref), dtype, atol=atol, record=f32)
            fwd = flare_fused_fwd(q, k, v)
            for what, got, want in zip(("y", "z", "max", "den", "lse"), fwd,
                                       ref.flare_fused_fwd_ref(q, k, v)):
                stat = what in ("den", "lse")   # den sums up to N terms: relative only
                checks.hold("flare_fused_fwd", what, got, want, dtype,
                            atol=None if stat else atol, record=f32 and what in ("y", "z"))
            # the backward on the kernel forward's own residuals
            dy = torch.randn(k.transpose(1, 2).shape, generator=gen).to(device, dtype)
            bwd_in = (q, k, v, *fwd[1:], fwd[0], dy.transpose(1, 2))
            for what, got, want in zip(GRADS, flare_fused_bwd(*bwd_in),
                                       ref.flare_fused_bwd_ref(*bwd_in)):
                checks.hold("flare_fused_bwd", what, got, want, dtype, atol=atol, record=f32)
    checks.raise_failures("kernels on random operands")


def check_main(checks: Checks, label: str, q, k, v):
    """Every kernel on block 0's own operands of a main-path shape, every
    batch element and head, against the plain version on the same inputs
    in fp64 (the fp32 plain version is itself a sum over N tokens, off fp64
    by more than the kernels are: its error is printed beside). The plain
    versions run a head at a time. Each output must also reject the fp64
    plain version with one token tile (encode) or latent tile (decode) left
    out. Returns the fp64 references (as tune_refs gives them; ``fwd64[0]``
    is the fp64 plain y)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    b, h, n, d = k.shape
    print(f"kernels {label} (block 0's operands, B={b} H={h} M={q.shape[1]} N={n} D={d} "
          f"fp32, k/v strides {k.stride()}; held against the plain version in fp64):",
          flush=True)
    f32 = torch.float32
    q64, k64, v64 = (t.to(torch.float64) for t in (q, k, v))
    drop_tokens = lambda fn: lambda qh, kh, vh: fn(qh, kh[:, :, TILE:], vh[:, :, TILE:])
    drop_latents = lambda qh, kh, zh: ref.flare_decode_ref(qh[:, TILE:], kh, zh[:, :, TILE:])

    z32 = by_head(ref.flare_encode_ref, q, k, v)
    z64 = by_head(ref.flare_encode_ref, q64, k64, v64)
    z64_drop = by_head(drop_tokens(ref.flare_encode_ref), q64, k64, v64)
    atol = ATOL["float32"]
    checks.hold("flare_encode", "z", flare_encode(q, k, v), z64, f32, atol=atol, record=True,
                dropped={"token tile": z64_drop}, fp32_plain=z32)
    y32 = by_head(ref.flare_decode_ref, q, k, z32)
    zz = z32.to(torch.float64)   # the decode's input, the same for every version
    dec64, dec_drop = by_head(ref.flare_decode_ref, q64, k64, zz), by_head(drop_latents, q64, k64, zz)
    checks.hold("flare_decode", "y", flare_decode(q, k, z32), dec64, f32, atol=atol, record=True,
                fp32_plain=y32, dropped={"latent tile": dec_drop})
    del y32, zz
    got = flare_fused_fwd(q, k, v)
    plain32 = by_head(ref.flare_fused_fwd_ref, q, k, v)
    want = by_head(ref.flare_fused_fwd_ref, q64, k64, v64)
    drops = {"y": by_head(ref.flare_decode_ref, q64, k64, z64_drop), "z": z64_drop}
    for what, g, w, p32 in zip(("y", "z", "max", "den", "lse"), got, want, plain32):
        stat = what in ("den", "lse")   # den sums up to N terms: relative only
        checks.hold("flare_fused_fwd", what, g, w, f32, atol=None if stat else atol,
                    record=what in drops, fp32_plain=p32,
                    dropped={"token tile": drops[what]} if what in drops else None)
    checks.raise_failures(f"kernels at {label}")
    return dict(fwd64=want, fwd_drop=drops, z_in=z32, dec64=dec64, dec_drop=dec_drop)


def bwd_chunk(b: int, m: int) -> int:
    """Tokens per chunk of the plain backward: [B, 1, M, chunk] temporaries of
    2**25 elements (256 MB in fp64)."""
    return max(256, 2**25 // (b * m))


def bwd_by_head(q, k, v, z, mx, den, lse, y, dy, *, drop=None, tile=TILE):
    """The plain backward a head at a time -> (dq [H, M, D], dk, dv
    [B, H, N, D]). ``drop="tokens"`` leaves the first ``tile`` tokens out of
    dZ's sum; ``drop="latents"`` leaves the first ``tile`` latents out of the
    sums over latents (dk, dv; its dq is that of the other latents);
    ``drop="dz latents"`` loses dZ's first ``tile`` latents (zeros, as a
    pass (a) that lost a latent tile would leave them)."""
    import torch

    from repro_torch.kernels import ref

    chunk = bwd_chunk(k.shape[0], q.shape[1])
    outs = []
    for i in range(q.shape[0]):
        hs = slice(i, i + 1)
        qh, kh, vh, zh, mxh, denh, lseh, yh, dyh = (
            q[hs], k[:, hs], v[:, hs], z[:, hs], mx[:, hs], den[:, hs], lse[:, hs], y[:, hs],
            dy[:, hs])
        if drop == "tokens":
            dz = ref.flare_bwd_dz_ref(qh, kh[:, :, tile:], lseh[:, :, tile:], dyh[:, :, tile:],
                                      chunk=chunk)
        else:
            dz = ref.flare_bwd_dz_ref(qh, kh, lseh, dyh, chunk=chunk)
        if drop == "dz latents":
            dz[:, :, :tile] = 0
        if drop == "latents":
            qh, zh, mxh, denh, dz = qh[:, tile:], zh[:, :, tile:], mxh[:, :, tile:], \
                denh[:, :, tile:], dz[:, :, tile:]
        outs.append(ref.flare_bwd_grads_ref(qh, kh, vh, zh, mxh, denh, lseh, yh, dyh, dz,
                                            chunk=chunk))
    dq, dk, dv = zip(*outs)
    return torch.cat(dq, dim=0), torch.cat(dk, dim=1), torch.cat(dv, dim=1)


def check_bwd_main(checks: Checks, label: str, q, k, v, dy):
    """The backward kernel on block 0's own q, k, v and a seeded dy, every
    batch element and head, against the plain backward in fp64 on the kernel
    forward's residuals (widened), a head at a time and chunked over tokens.
    Each gradient must reject the fp64 plain backward with one 256-token tile
    of dZ left out, and dk also the one with 256 latents left out. Returns
    the forward's y and residuals for the timing, the fp64 gradients, and
    the references as tune_refs gives them (``bwd_in``, ``bwd64``,
    ``bwd_drop``)."""
    import torch

    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd

    b, h, n, d = k.shape
    print(f"kernels {label} backward (block 0's operands, seeded dy, B={b} H={h} "
          f"M={q.shape[1]} N={n} D={d} fp32, chunk {bwd_chunk(b, q.shape[1])}; held against "
          "the plain backward in fp64):", flush=True)
    y, *res = flare_fused_fwd(q, k, v)
    inputs = (q, k, v, *res, y, dy)
    got = flare_fused_bwd(*inputs)
    torch.cuda.synchronize()
    plain32 = bwd_by_head(*inputs)
    wide = tuple(t.to(torch.float64) for t in inputs)
    want = bwd_by_head(*wide)
    no_tile = bwd_by_head(*wide, drop="tokens")
    no_latents = bwd_by_head(*wide, drop="latents")
    for i, what in enumerate(GRADS):
        dropped = {"dZ token tile": no_tile[i]}
        if what == "dk":
            dropped["latent tile"] = no_latents[i]
        scale = want[i].abs().max().item()
        if BWD_ATOL[what] > 1e-4 * scale:
            checks.failures.append(f"flare_fused_bwd {what}: atol {BWD_ATOL[what]:g} is looser "
                                   f"than 1e-4 of max|plain| {scale:.4g}")
        checks.hold("flare_fused_bwd", what, got[i], want[i], torch.float32,
                    atol=BWD_ATOL[what], record=True, dropped=dropped, fp32_plain=plain32[i])
    checks.raise_failures(f"backward kernel at {label}")
    return y, res, want, dict(bwd_in=inputs, bwd64=want, bwd_drop=(no_tile, no_latents))


def time_kernels(q, k, v) -> dict:
    """CUDA-event times of each kernel, its plain version (a head at a time)
    and the SDPA yardstick on the same operands, with the bound of the work."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    b, h, n, d = k.shape
    m = q.shape[1]
    z = flare_encode(q, k, v)
    qb = q.expand(b, h, m, d)
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, scale=1.0)
    runs = {
        "flare_encode": (lambda: flare_encode(q, k, v),
                         lambda: by_head(ref.flare_encode_ref, q, k, v),
                         lambda: sdpa(qb, k, v)),
        "flare_decode": (lambda: flare_decode(q, k, z),
                         lambda: by_head(ref.flare_decode_ref, q, k, z),
                         lambda: sdpa(k, qb, z)),
        "flare_fused_fwd": (lambda: flare_fused_fwd(q, k, v),
                            lambda: by_head(ref.flare_fused_fwd_ref, q, k, v),
                            lambda: sdpa(k, qb, sdpa(qb, k, v))),
    }
    f4, mnd = 4, b * h * m * n * d
    qkv = f4 * (h * m * d + 2 * b * h * n * d)
    work = {   # (FLOP, bytes): each input read once, each output written once
        "flare_encode": (2 * 2 * mnd, qkv + f4 * b * h * m * d),
        "flare_decode": (2 * 2 * mnd, qkv + f4 * b * h * m * d),
        # the scores are needed once: three products
        "flare_fused_fwd": (3 * 2 * mnd, qkv + f4 * (b * h * n * (d + 1) + b * h * m * (d + 2))),
    }
    # the floors of the tensor-core design (csrc/flare.cu): its exps on the
    # special-function units (16 a clock an SM) at the card's top SM clock,
    # its products, each three TF32 MMAs, at the TF32 peak; the encode and
    # the decode take half of the fused forward's each
    pairs, sm_hz = b * h * m * n, max_sm_clock_mhz() * 1e6
    share = {"flare_encode": 0.5, "flare_decode": 0.5, "flare_fused_fwd": 1.0}
    stats = {}
    for name, (kern, plain, lib) in runs.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BW * 1e3
        stats[name] = dict(
            ms=cuda_ms(kern, reps=10), plain_ms=cuda_ms(plain, reps=2),
            library_ms=cuda_ms(lib, reps=5), bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            floor_exps_ms=share[name] * FWD_EXPS * pairs / (16 * 132 * sm_hz) * 1e3,
            floor_split_products_ms=share[name] * 3 * FWD_PRODUCTS * 2 * pairs * d / PEAK_TF32
            * 1e3)
    return stats


def time_bwd(q, k, v, dy, y, res) -> dict:
    """CUDA-event times of the backward kernel, its plain version (a head at
    a time, chunked) and autograd's backward through two SDPA calls on the
    same operands, with the bound of the work: seven products of
    2*B*H*M*N*D FLOP (S, dZ, dW, dA, dk, dv, dq) at the peak of the
    operands' dtype (bf16 tensor cores; fp32 CUDA cores); bytes of q, k, v,
    y, dy and dq, dk, dv in that dtype and the fp32 residuals, each once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flare_packed import flare_fused_bwd

    b, h, n, d = k.shape
    m = q.shape[1]
    inputs = (q, k, v, *res, y, dy)
    qe = q.detach().clone().requires_grad_(True)
    kk, vv = (t.detach().clone().requires_grad_(True) for t in (k, v))
    qb = qe.expand(b, h, m, d)
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, scale=1.0)
    y_lib = sdpa(kk, qb, sdpa(qb, kk, vv))
    es, mnd = k.element_size(), b * h * m * n * d
    flops = 7 * 2 * mnd
    nbytes = es * (2 * h * m * d + 6 * b * h * n * d) + 4 * (b * h * n + b * h * m * (d + 2))
    peak = PEAK_BF16 if es == 2 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BW * 1e3
    stats = dict(
        ms=cuda_ms(lambda: flare_fused_bwd(*inputs), reps=5),
        plain_ms=cuda_ms(lambda: bwd_by_head(*inputs), reps=1, warmup=0),
        library_ms=cuda_ms(lambda: torch.autograd.grad(y_lib, (qe, kk, vv), dy,
                                                       retain_graph=True), reps=3),
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the floors of the tensor-core design (csrc/flare_bwd.cu): its exps on
    # the special-function units (16 a clock an SM) at the card's top SM
    # clock, and its products, each three TF32 MMAs, at the TF32 peak
    pairs, sm_hz = b * h * m * n, max_sm_clock_mhz() * 1e6
    stats["floor_exps_ms"] = BWD_EXPS * pairs / (16 * 132 * sm_hz) * 1e3
    stats["floor_split_products_ms"] = 3 * BWD_PRODUCTS * 2 * pairs * d / PEAK_TF32 * 1e3
    del y_lib
    return stats


def forward_ms(model, net, batch, reps: int):
    """Host clock around synchronized forwards after one warm-up; also the
    peak device memory of one forward."""
    import torch

    out = model.forward(net, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = model.forward(net, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return out, ms, torch.cuda.max_memory_allocated() / 2**30


def check_output(name: str, out, batch) -> float:
    from repro_torch.models.pde import relative_l2

    want = tuple(batch["y"].shape)
    if tuple(out.shape) != want:
        raise AssertionError(f"{name}: output {tuple(out.shape)}, expected {want}")
    if not bool(out.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    rel = relative_l2(out, batch["y"]).item()
    if not math.isfinite(rel):
        raise AssertionError(f"{name}: rel-L2 {rel}")
    return rel


def traced(fn):
    """One call of ``fn`` under torch.profiler, recording the device's
    activity alone (tracing host ops too stretches the wall of a call of
    ~10^5 kernels by a quarter and leaves the device times as they are).
    Returns (fn's result, (the profile, wall ms))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, (prof, wall_ms)


def breakdown(fn, label: str, top: int = 8):
    """Device time of one (warm) call of ``fn`` by kernel name, the number
    of kernels it launched, and the device's busy share of its wall time
    (see ``report``)."""
    return report(*traced(fn)[1], label, top)


def report(prof, wall_ms: float, label: str, top: int = 8):
    """Print a profile's device time by kernel name, its kernel count and
    the device's busy share of ``wall_ms``. Returns ({kernel name: device
    ms}, wall ms), or None where the profiler recorded no device time. It
    sums the trace's raw device events (``key_averages`` would first build
    an object an event: about 0.18 ms each, 35 s for a train step's 2e5
    kernels)."""
    from torch.autograd import DeviceType

    sums = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            row = sums[e.name()]
            row[0] += e.duration_ns()
            row[1] += 1
    rows = [(key, ns / 1e6, count) for key, (ns, count) in sums.items()]
    total = sum(ms for _, ms, _ in rows)
    if total == 0:
        print(f"breakdown {label}: the profiler recorded no device time (not measured)")
        return None
    print(f"breakdown {label}: wall {wall_ms:.3f} ms, device busy {total:.3f} ms "
          f"({100 * total / wall_ms:.1f}%), {sum(c for _, _, c in rows)} kernels")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {100 * ms / total:5.1f}%  {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {key: ms for key, ms, _ in rows}, wall_ms


def assert_route(seen, label: str, want: tuple, refuse: tuple = ()) -> None:
    """The kernels a breakdown saw (its {kernel name: device ms}): every name
    in ``want`` must be among them and none in ``refuse``, so the path is
    shown to run the kernels it is meant to."""
    if seen is None:
        raise AssertionError(f"{label}: the profiler recorded no kernel, the route is not shown")
    names = list(seen[0])
    missing = [w for w in want if not any(w in key for key in names)]
    found = [r for r in refuse if any(r in key for key in names)]
    print(f"route {label}: {', '.join(want)} launched"
          + (f"; none of {', '.join(refuse)}" if refuse else ""), flush=True)
    if missing or found:
        raise AssertionError(f"{label}: kernels {missing} not launched, {found} launched")


FWD_TC = ("encode_tc_kernel", "decode_tc_kernel")   # csrc/flare.cu's tensor-core instances


def train(cfg, shape) -> dict:
    """Trainer.fit at full width and depth on pde_40k point clouds: launch
    counts zeroed just before the fit and read just after; checkpoints into
    a temporary directory, restored by a second trainer."""
    import tempfile

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.data.pde_data import pointcloud_batch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer

    model = get_model(cfg)
    plan = model.plans["train"].describe()
    print(f"training {cfg.name}: plans {{train: {plan}, infer: {model.plans['infer'].describe()}}}"
          f" at {shape.name} B={shape.global_batch} N={shape.seq_len}, {TRAIN_STEPS} steps, "
          f"peak lr {TRAIN_LR}", flush=True)
    if model.plans["train"].backend != "packed":
        raise AssertionError(f"train plan {plan} is not the fused kernels")
    batches = [pointcloud_batch(SEED, i, shape.global_batch, grid=256, num_points=shape.seq_len)
               for i in range(4)]
    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=TRAIN_LR, seed=SEED,
                           checkpoint_every=10, checkpoint_dir=ckdir, log_every=5)
        trainer = Trainer(model, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        history = trainer.fit(lambda step: batches[step % len(batches)])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        resumed = Trainer(model, tcfg)
        same = all(torch.equal(a, b) for a, b in zip(trainer.net.parameters(),
                                                    resumed.net.parameters()))
        steps_saved = trainer.ckpt.all_steps()
    losses = [h["loss"] for h in history]
    step_ms = [1e3 * h["time"] for h in history]
    ms = sum(step_ms[2:]) / len(step_ms[2:])
    print(f"train losses: {[round(x, 6) for x in losses]}")
    print(f"train grad_norm: {[round(h['grad_norm'], 4) for h in history]}")
    print(f"train ms/step: {[round(t, 3) for t in step_ms]}")
    print(f"train {shape.name}: {ms:.3f} ms/step (mean of steps 3-{TRAIN_STEPS}, host clock "
          f"around synchronized steps), peak {peak:.2f} GiB; launches {counts}; checkpoints "
          f"{steps_saved}, restored at step {resumed.step} equal: {same}", flush=True)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    per_step = TRAIN_STEPS * cfg.num_layers
    if not (counts["flare_fused_fwd"] == counts["flare_fused_bwd"] == per_step
            and counts["flare_encode"] == counts["flare_decode"] == 0):
        raise AssertionError(f"train path launches {counts}")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"loss did not fall: first 5 mean {first}, last 5 mean {last}")
    if not (same and resumed.step == TRAIN_STEPS):
        raise AssertionError("the checkpoint did not restore the trained parameters")
    print(f"train loss: mean of first 5 {first:.6f}, last 5 {last:.6f}", flush=True)
    # before the profiler runs: ops after a profiler session took 5x longer
    print(f"adamw: {adamw_ms(trainer.net):.3f} ms/update over "
          f"{len(list(trainer.net.parameters()))} parameter tensors", flush=True)
    batch = batches[0]
    seen = breakdown(lambda: trainer._train_step(trainer.net, trainer.opt_state, batch),
                     f"train step {shape.name}", top=12)
    assert_route(seen, f"train step {shape.name}", FWD_TC)
    return {"counts": counts, "ms": ms, "peak": peak}


def adamw_ms(net, reps: int = 10) -> float:
    """Host clock around synchronized AdamW updates of a copy of the model's
    parameters with random gradients, after a warm-up."""
    import torch

    from repro_torch.optim import adamw_update, init_adamw

    params = {k: p.detach().clone() for k, p in net.named_parameters()}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    state = init_adamw(params)
    update = lambda: adamw_update(params, grads, state, lr=1e-4, weight_decay=1e-5,
                                  grad_clip=1.0)
    update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        update()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def train_1m(cfg, shape, steps: int = 3) -> dict:
    """A few train steps at pde_1m through the kernels: launch counts zeroed
    just before and read just after, ms per step after the first, peak GiB."""
    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.data.pde_data import darcy_batch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.optim import init_adamw
    from repro_torch.train import make_train_step

    model = get_model(cfg)
    net = model.init(SEED)
    batch = darcy_batch(SEED, 1, shape.global_batch, grid=int(math.isqrt(shape.seq_len)))
    step_fn = make_train_step(model.loss, TrainConfig(steps=steps, learning_rate=TRAIN_LR,
                                                      seed=SEED))
    opt = init_adamw(dict(net.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step_fn(net, opt, batch)[2]["loss"]))   # float() syncs
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = sum(times[1:]) / len(times[1:])
    print(f"train {shape.name} B={shape.global_batch} N={shape.seq_len}: ms/step "
          f"{[round(t, 3) for t in times]}, {ms:.3f} ms/step after the first, peak {peak:.2f} "
          f"GiB, losses {losses}, launches {counts}", flush=True)
    if not (counts["flare_fused_fwd"] == counts["flare_fused_bwd"] == steps * cfg.num_layers
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"pde_1m training: launches {counts}, losses {losses}")
    return counts


def train_paths_agree(cfg) -> None:
    """5 steps under the packed kernels and 5 under the plain sdpa path from
    the same weights and batches, at B=2, N=4,096 (the plain path's saved
    scores fit there): loss and grad_norm per step, parameters after."""
    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.data.pde_data import pointcloud_batch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.optim import init_adamw
    from repro_torch.train import make_train_step

    steps = 5
    tcfg = TrainConfig(steps=steps, learning_rate=TRAIN_LR, seed=SEED)
    batches = [pointcloud_batch(SEED, 100 + i, 2, grid=128, num_points=4096)
               for i in range(steps)]
    runs = {}
    for backend in ("packed", "sdpa"):
        model = get_model(cfg, policy=MixerPolicy(backends=(backend,)))
        net = model.init(SEED)
        step_fn = make_train_step(model.loss, tcfg)
        opt = init_adamw(dict(net.named_parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        mets = [step_fn(net, opt, batch)[2] for batch in batches]
        runs[backend] = dict(
            loss=[float(x["loss"]) for x in mets], gnorm=[float(x["grad_norm"]) for x in mets],
            params={k: p.detach().clone() for k, p in net.named_parameters()},
            counts=launch_counts(), peak=torch.cuda.max_memory_allocated() / 2**30)
        print(f"train path {backend} B=2 N=4096: losses {runs[backend]['loss']}, grad_norm "
              f"{runs[backend]['gnorm']}, peak {runs[backend]['peak']:.2f} GiB, launches "
              f"{runs[backend]['counts']}", flush=True)
    pk, pl = runs["packed"], runs["sdpa"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(pk["loss"], pl["loss"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(pk["gnorm"], pl["gnorm"]))
    param_err = max((pk["params"][k] - pl["params"][k]).abs().max().item() for k in pk["params"])
    print(f"train path packed vs sdpa over {steps} steps: loss rel {loss_rel:.3g}, grad_norm rel "
          f"{gnorm_rel:.3g} (limit {TRAIN_TOL:g}), parameters max abs diff {param_err:.3g} "
          f"(limit {PARAM_TOL_LR:g} x lr = {PARAM_TOL_LR * TRAIN_LR:g})", flush=True)
    if pk["counts"]["flare_fused_bwd"] != steps * cfg.num_layers or pl["counts"]["flare_fused_bwd"]:
        raise AssertionError(f"launches packed {pk['counts']}, sdpa {pl['counts']}")
    if not (loss_rel <= TRAIN_TOL and gnorm_rel <= TRAIN_TOL
            and param_err <= PARAM_TOL_LR * TRAIN_LR):
        raise AssertionError("the packed training path differs from the plain path")


# --------------------------------------------------------------------------
# The launch-parameter autotuner (backends/autotune.py) on the card
# --------------------------------------------------------------------------


class OneRankMesh:
    """What the plan builders read of a DeviceMesh (axis names and sizes), for
    ``packed_shard`` on its group of one: no process group is needed to
    plan, and its runner and the checks below run without collectives."""

    mesh_dim_names = ("data",)

    def size(self, dim: int = 0) -> int:
        return 1


def tune_refs(q, k, v, dy) -> dict:
    """What every candidate is held against at one shape, computed once (the
    checks of check_main and check_bwd_main): the fused forward's plain
    version in fp64 (its z is the encode's), with one token tile left out;
    the decode's of the fp64 z rounded to fp32, with one latent tile left
    out; the default forward's own residuals, on which every candidate's
    backward runs, and the plain backward in fp64 on them, with one dZ token
    tile and one latent tile left out."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    q64, k64, v64 = (t.double() for t in (q, k, v))
    fwd64 = by_head(ref.flare_fused_fwd_ref, q64, k64, v64)
    z_drop = by_head(lambda qh, kh, vh: ref.flare_encode_ref(qh, kh[:, :, TILE:], vh[:, :, TILE:]),
                     q64, k64, v64)
    z_in = fwd64[1].float()
    zz = z_in.double()
    y, *res = flare_fused_fwd(q, k, v)
    bwd_in = (q, k, v, *res, y, dy)
    wide = tuple(t.double() for t in bwd_in)
    return dict(
        fwd64=fwd64, fwd_drop={"y": by_head(ref.flare_decode_ref, q64, k64, z_drop), "z": z_drop},
        z_in=z_in, dec64=by_head(ref.flare_decode_ref, q64, k64, zz),
        dec_drop=by_head(lambda qh, kh, zh: ref.flare_decode_ref(qh[:, TILE:], kh, zh[:, :, TILE:]),
                         q64, k64, zz),
        bwd_in=bwd_in, bwd64=bwd_by_head(*wide),
        bwd_drop=(bwd_by_head(*wide, drop="tokens"), bwd_by_head(*wide, drop="latents")))


def tune_hold(checks: Checks, kind: str, params: dict, refs: dict, q, k, v) -> dict:
    """One candidate of backend ``kind`` against the fp64 references, as
    check_main and check_bwd_main hold the default (each limit rejecting a
    lost tile): ``pallas``, the encode and the decode; ``packed``, the fused
    forward and, with the candidate's split, the backward on the default
    forward's residuals; ``packed_shard``, its entry points on a group of
    one. Returns {output: rel error}."""
    import torch

    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd
    from repro_torch.kernels.flare_packed_shard import (
        combine_stats,
        flare_enc_stats,
        flare_shard_decode,
        flare_shard_dz,
        flare_shard_grads,
    )

    f32, atol = torch.float32, ATOL["float32"]
    bm, bn = params["block_m"], params["block_n"]
    tag = f"{kind} block_m={bm} block_n={bn}"
    hold = lambda name, what, got, want, a, drop: checks.hold(
        f"{name} [{tag}]", what, got, want, f32, atol=a, dropped=drop, quiet=True)
    fwd64, drops = refs["fwd64"], refs["fwd_drop"]
    rels = {}
    if kind == "pallas":
        rels["z"] = hold("flare_encode", "z", flare_encode(q, k, v, block_m=bm, block_n=bn),
                         fwd64[1], atol, {"token tile": drops["z"]})
        rels["y"] = hold("flare_decode", "y", flare_decode(q, k, refs["z_in"], block_m=bm),
                         refs["dec64"], atol, {"latent tile": refs["dec_drop"]})
        return rels
    if kind == "packed":
        got = flare_fused_fwd(q, k, v, block_m=bm, block_n=bn)
    else:
        num, mx, den = flare_enc_stats(q, k, v, block_m=bm, block_n=bn)
        z, mx, den = combine_stats(num, mx, den, None)
        y, lse = flare_shard_decode(q, k, z, block_m=bm)
        got = (y, z, mx, den, lse)
    for what, g, w in zip(("y", "z", "max", "den", "lse"), got, fwd64):
        stat = what in ("den", "lse")   # den sums up to N terms: relative only
        rels[what] = hold("flare_fused_fwd" if kind == "packed" else "flare_shard", what, g, w,
                          None if stat else atol,
                          {"token tile": drops[what]} if what in drops else None)
    q_, k_, v_, z0, mx0, den0, lse0, y0, dy = refs["bwd_in"]
    if kind == "packed":
        grads = flare_fused_bwd(*refs["bwd_in"], block_n=bn)
    else:
        dz = flare_shard_dz(q_, k_, lse0, dy, block_n=bn)
        grads = flare_shard_grads(q_, k_, v_, z0, mx0, den0, lse0, y0, dy, dz, block_n=bn)
    no_tile, no_latents = refs["bwd_drop"]
    for i, what in enumerate(GRADS):
        dropped = {"dZ token tile": no_tile[i]}
        if what == "dk":
            dropped["latent tile"] = no_latents[i]
        rels[what] = hold("flare_fused_bwd" if kind == "packed" else "flare_shard", what,
                          grads[i], refs["bwd64"][i], BWD_ATOL[what], dropped)
    return rels


def tune_line(kind: str, label: str, shape, entry: dict, default: dict) -> dict:
    """Print the ``tune`` line of a kind and shape from the cache entry the
    search stored: every candidate's ms, the default's and the winner's.
    Returns {"default_ms", "winner", "winner_ms"}."""
    fmt = lambda p: f"block_m={p['block_m']};block_n={p['block_n']}"
    timed = {fmt(c): c["us"] / 1e3 for c in entry["timed"]}
    winner = {"block_m": entry["block_m"], "block_n": entry["block_n"]}
    out = {"default_ms": timed[fmt(default)], "winner": fmt(winner),
           "winner_ms": entry["us"] / 1e3}
    print(f"tune {kind} {label} (B={shape.batch} H={shape.heads} M={shape.latents} "
          f"N={shape.tokens} D={shape.head_dim} fp32, median of 3 by CUDA events"
          f"{', forward and backward' if kind != 'pallas' else ', forward'}): "
          f"{len(timed)} candidates {{{', '.join(f'{c}: {ms:.3f}' for c, ms in timed.items())}}} "
          f"ms; default {fmt(default)} {out['default_ms']:.3f} ms; winner {out['winner']} "
          f"{out['winner_ms']:.3f} ms ({out['winner_ms'] / out['default_ms']:.3f} of the "
          "default)", flush=True)
    return out


# the kernel rows whose launch parameters the tuner sets, by the backend
# (parameter kind) whose winner they take
TUNED_ROWS = {"flare_encode": "pallas", "flare_decode": "pallas", "flare_fused_fwd": "packed",
              "flare_fused_bwd": "packed", "flare_enc_stats": "packed_shard",
              "flare_shard_decode": "packed_shard", "flare_shard_dz": "packed_shard",
              "flare_shard_grads": "packed_shard"}


def tune_times(shape, refs: dict, winners: dict) -> dict:
    """CUDA-event ms of each tuned kernel row on block 0's operands under the
    default parameters and under its backend's winner, in turns (default,
    winner, winner, default; 3 calls each after a warm-up), the two means
    printed. Returns {row: {"default_ms", "winner_ms"}}."""
    from repro_torch.backends import autotune
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd
    from repro_torch.kernels.flare_packed_shard import (
        flare_enc_stats,
        flare_shard_decode,
        flare_shard_dz,
        flare_shard_grads,
    )

    q, k, v, z, mx, den, lse, y, dy = refs["bwd_in"]
    dz = flare_shard_dz(q, k, lse, dy)
    calls = {
        "flare_encode": lambda p: flare_encode(q, k, v, **p),
        "flare_decode": lambda p: flare_decode(q, k, refs["z_in"], block_m=p["block_m"]),
        "flare_fused_fwd": lambda p: flare_fused_fwd(q, k, v, **p),
        "flare_fused_bwd": lambda p: flare_fused_bwd(*refs["bwd_in"], block_n=p["block_n"]),
        "flare_enc_stats": lambda p: flare_enc_stats(q, k, v, **p),
        "flare_shard_decode": lambda p: flare_shard_decode(q, k, z, block_m=p["block_m"]),
        "flare_shard_dz": lambda p: flare_shard_dz(q, k, lse, dy, block_n=p["block_n"]),
        "flare_shard_grads": lambda p: flare_shard_grads(q, k, v, z, mx, den, lse, y, dy, dz,
                                                         block_n=p["block_n"]),
    }
    default = autotune.default_tiles(shape)
    out = {}
    for row, call in calls.items():
        win = winners[TUNED_ROWS[row]]
        d1, w1, w2, d2 = (cuda_ms(lambda p=p: call(p), reps=3)
                          for p in (default, win, win, default))
        out[row] = {"default_ms": (d1 + d2) / 2, "winner_ms": (w1 + w2) / 2}
    print("tune time (default -> winner ms): " + ", ".join(
        f"{row} {t['default_ms']:.3f} -> {t['winner_ms']:.3f}" for row, t in out.items()),
        flush=True)
    return out


def tuned_model_agrees(cfg, net, batch, shape, plans: dict) -> None:
    """One pde_40k forward and one train step under the tuned ``packed`` plan
    against the same under the default plan (the default parameters bound to
    the same shape), from the same weights and batch: the forward at
    PATH_TOL, the loss and grad norm at TRAIN_TOL, the parameters after at
    PARAM_TOL_LR x lr; the fused kernels launched under each."""
    import copy

    import torch

    from repro_torch.backends import autotune
    from repro_torch.config import TrainConfig
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.optim import init_adamw
    from repro_torch.train import make_train_step

    runs = {}
    for name, plan in plans.items():
        model = get_model(cfg, policy=plan)
        mine = copy.deepcopy(net)
        reset_launch_counts()
        y = model.forward(mine, batch)
        step_fn = make_train_step(model.loss, TrainConfig(steps=1, learning_rate=TRAIN_LR,
                                                          seed=SEED))
        met = step_fn(mine, init_adamw(dict(mine.named_parameters())), batch)[2]
        torch.cuda.synchronize()
        counts = launch_counts()
        runs[name] = dict(y=y, loss=float(met["loss"]), gnorm=float(met["grad_norm"]),
                          params={k: p.detach() for k, p in mine.named_parameters()})
        print(f"tune model {name} plan {plan.describe()} at B={shape.batch} N={shape.tokens}: "
              f"loss {runs[name]['loss']:.6f}, grad_norm {runs[name]['gnorm']:.6f}, launches "
              f"fwd {counts['flare_fused_fwd']} bwd {counts['flare_fused_bwd']}", flush=True)
        if not (counts["flare_fused_fwd"] == 2 * cfg.num_layers
                and counts["flare_fused_bwd"] == cfg.num_layers):
            raise AssertionError(f"tuned model {name}: launches {counts}")
        dev = batch["x"].device
        q = torch.empty(shape.heads, shape.latents, shape.head_dim, device=dev)
        k = torch.empty(shape.batch, shape.heads, shape.tokens, shape.head_dim, device=dev)
        if autotune.launch_params(plan, q, k, "packed") != {
                p: plan.params[p] for p in ("block_n", "block_m")}:
            raise AssertionError(f"{name}: the plan's parameters do not reach its calls")
    t, d = runs["tuned"], runs["default"]
    err, scale = max_err(t["y"], d["y"]), d["y"].abs().max().item()
    loss_rel = abs(t["loss"] - d["loss"]) / abs(d["loss"])
    gnorm_rel = abs(t["gnorm"] - d["gnorm"]) / abs(d["gnorm"])
    param_err = max((t["params"][k] - d["params"][k]).abs().max().item() for k in d["params"])
    print(f"tune model tuned vs default: forward max abs err {err:.3g}, rel {err / scale:.3g} "
          f"(limit {PATH_TOL}); one train step: loss rel {loss_rel:.3g}, grad_norm rel "
          f"{gnorm_rel:.3g} (limit {TRAIN_TOL:g}), parameters max abs diff {param_err:.3g} "
          f"(limit {PARAM_TOL_LR * TRAIN_LR:g})", flush=True)
    if not (err <= PATH_TOL and err / scale <= PATH_TOL and loss_rel <= TRAIN_TOL
            and gnorm_rel <= TRAIN_TOL and param_err <= PARAM_TOL_LR * TRAIN_LR):
        raise AssertionError("the tuned plan's model differs from the default plan's")


def tune_phase(checks: Checks, device, net=None, batches=None, refs=None) -> dict:
    """``tune``: the autotuner's search on the card. With a fresh cache file
    and autotuning forced on, resolve ``pallas``, ``packed`` and
    ``packed_shard`` (on a group of one) at block 0's shape of flare_pde at
    pde_40k and pde_1m, fp32: each times its candidates (backends/autotune.py)
    and stores the winner under a key naming torch, CUDA and this card. Every
    candidate, the winner and the default among them, is held against the
    plain version in fp64 as the kernels' own checks hold the default. A
    ``tune`` line a kind and shape gives every candidate's ms. Resolved again
    with autotuning off, each plan must be a cache hit carrying the winner.
    Each tuned kernel row is then timed under the default and under its
    backend's winner (tune_times). Last, one pde_40k forward and one train
    step under the tuned ``packed`` plan against the default plan. The
    cache file is removed and the previous one restored. ``refs``: {shape:
    the fp64 references of check_main and check_bwd_main on block 0's
    operands}, else tune_refs computes them. Returns {row: {shape:
    {"winner", "default_ms", "winner_ms"}}}."""
    import torch

    from repro_torch.backends import autotune
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MixerPlan, MixerShape, resolve
    from repro_torch.data.pde_data import darcy_batch, pointcloud_batch
    from repro_torch.models.api import get_model

    import tempfile

    t_phase = time.perf_counter()
    cfg = get_config("flare_pde")
    if net is None:
        net = get_model(cfg).init(SEED)
    if batches is None:
        s40, s1m = SHAPES["pde_40k"], SHAPES["pde_1m"]
        batches = {"pde_40k": pointcloud_batch(SEED, 0, s40.global_batch, grid=256,
                                               num_points=s40.seq_len),
                   "pde_1m": darcy_batch(SEED, 1, s1m.global_batch,
                                         grid=int(math.isqrt(s1m.seq_len)))}
    saved = os.environ.get(autotune.CACHE_ENV)
    tmp = tempfile.TemporaryDirectory(prefix="tune_")
    cache = Path(tmp.name) / "autotune.json"
    os.environ[autotune.CACHE_ENV] = str(cache)
    autotune._MEM_CACHE.clear()
    counters = lambda: (autotune._M_HITS.value, autotune._M_MEASURED.value)
    gen = torch.Generator().manual_seed(SEED + 2)
    mesh = OneRankMesh()
    found, times, winners, tuned40 = {}, {}, {}, None
    try:
        for label, batch in batches.items():
            if refs is not None:
                ref_set = refs[label]
                q, k, v = ref_set["bwd_in"][:3]
            else:
                q, k, v = mixer_operands(net, batch["x"])
                dy = torch.randn(k.shape[0], k.shape[2], k.shape[1], k.shape[3],
                                 generator=gen).to(device).transpose(1, 2)
                ref_set = tune_refs(q, k, v, dy)
            shape = MixerShape.from_qkv(q, k)
            print(f"tune {label}: block 0's operands B={shape.batch} H={shape.heads} "
                  f"M={shape.latents} N={shape.tokens} D={shape.head_dim} fp32; cache {cache}",
                  flush=True)
            for name in ("pallas", "packed", "packed_shard"):
                kind = "tiles" if name == "pallas" else "packed"
                m = mesh if name == "packed_shard" else None
                mkey = (1,) if m is not None else None
                hits, measured = counters()
                with autotune.forced(True):
                    plan = resolve(name, shape=shape, dtype=torch.float32, device="cuda",
                                   mesh=m)[1]
                if counters() != (hits, measured + 1):
                    raise AssertionError(f"tune {name} {label}: not measured once "
                                         f"({counters()} after {(hits, measured)})")
                key = autotune.cache_key(shape, torch.float32, torch.cuda.get_device_name(),
                                         kind, mkey)
                if not (autotune.runtime_version() in key
                        and f"cuda{torch.version.cuda}" in key
                        and torch.cuda.get_device_name() in key):
                    raise AssertionError(f"tune key {key}")
                entry = json.loads(cache.read_text())[key]
                cands = autotune._CANDIDATES[kind](shape)
                default = autotune._DEFAULTS[kind](shape)
                if len(entry["timed"]) != len(cands) or default not in cands:
                    raise AssertionError(f"tune {name} {label}: timed {len(entry['timed'])} of "
                                         f"{len(cands)} candidates")
                found.setdefault(name, {})[label] = tune_line(name, label, shape, entry,
                                                              default)
                rels = {}
                for params in cands:
                    for what, rel in tune_hold(checks, name, params, ref_set, q, k, v).items():
                        rels[what] = max(rels.get(what) or 0.0, rel or math.inf)
                print(f"  tune {name} {label}: every candidate held against fp64, worst rel "
                      f"{ {w: float(f'{r:.3g}') for w, r in rels.items()} } (rtol "
                      f"{RTOL['float32']:g}; each limit rejects a lost tile)", flush=True)
                # resolved again with autotuning off: a hit carrying the winner
                with autotune.forced(False):
                    again = resolve(name, shape=shape, dtype=torch.float32, device="cuda",
                                    mesh=m)[1]
                winner = {p: entry[p] for p in ("block_m", "block_n")}
                if counters() != (hits + 1, measured + 1) or any(
                        again.params[p] != winner[p] or plan.params[p] != winner[p]
                        for p in winner):
                    raise AssertionError(f"tune {name} {label}: second resolve "
                                         f"{again.describe()}, winner {winner}, counters "
                                         f"{counters()} after {(hits, measured)}")
                winners[name] = winner
                if name == "packed" and label == "pde_40k":
                    tuned40 = (shape, again)
            checks.raise_failures(f"tune {label}")
            for row, t in tune_times(shape, ref_set, winners).items():
                times.setdefault(row, {})[label] = {"winner": found[TUNED_ROWS[row]][label][
                    "winner"], **t}
            del q, k, v, ref_set
            torch.cuda.empty_cache()
        shape, tuned = tuned40
        default = MixerPlan("packed", {**autotune.default_packed(shape), "shape": shape})
        tuned_model_agrees(cfg, net, batches["pde_40k"], shape,
                           {"default": default, "tuned": tuned})
    finally:
        if saved is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = saved
        autotune._MEM_CACHE.clear()
        tmp.cleanup()
    print(f"tune phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return times


# --------------------------------------------------------------------------
# Widened head dims, and the sharded mixer: its four entry points and the
# sequence-parallel trainer on a process group
# --------------------------------------------------------------------------


def check_wide(checks: Checks, device) -> None:
    """The bidirectional kernels at head dims beside the paper's (each D runs
    at the padded width above it, its lanes beyond D zero) on random
    operands: encode, decode, fused forward and backward, fp32 and bf16,
    against the plain version in fp64 on the same values (fp32 1e-5, bf16
    1e-2 of max |plain|). Then what "auto" resolves to on the card at D on
    both sides of each kernel's limit."""
    import torch

    from repro_torch.core.dispatch import MixerShape
    from repro_torch.core.policy import resolve_policy
    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd

    gen = torch.Generator().manual_seed(SEED + 3)
    for d in WIDE_D:
        s = dict(WIDE_SHAPE, d=d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(s, dtype, gen, device)
            print(f"kernels widened-D {s} {dtype}:", flush=True)
            wide = tuple(t.double() for t in (q, k, v))
            z64 = ref.flare_encode_ref(*wide)
            atol = ATOL[str(dtype).removeprefix("torch.")]
            hold = lambda name, what, got, want, plain, atol=atol: checks.hold(
                name, f"{what} D={d}", got, want, dtype, atol=atol, fp32_plain=plain)
            hold("flare_encode", "z", flare_encode(q, k, v), z64, ref.flare_encode_ref(q, k, v))
            zq = z64.to(dtype)
            hold("flare_decode", "y", flare_decode(q, k, zq),
                 ref.flare_decode_ref(*wide[:2], zq.double()), ref.flare_decode_ref(q, k, zq))
            fwd = flare_fused_fwd(q, k, v)
            want = ref.flare_fused_fwd_ref(*wide)
            hold("flare_fused_fwd", "y", fwd[0], want[0], ref.flare_fused_fwd_ref(q, k, v)[0])
            hold("flare_fused_fwd", "z", fwd[1], want[1], ref.flare_fused_fwd_ref(q, k, v)[1])
            dy = torch.randn(k.transpose(1, 2).shape, generator=gen).to(device, dtype)
            bwd_in = (q, k, v, *fwd[1:], fwd[0], dy.transpose(1, 2))
            plain = ref.flare_fused_bwd_ref(*bwd_in)
            for what, got, w64, p in zip(GRADS, flare_fused_bwd(*bwd_in),
                                         ref.flare_fused_bwd_ref(*(t.double() for t in bwd_in)),
                                         plain):
                hold("flare_fused_bwd", what, got, w64, p, atol=None)
    for kind in ("bidirectional, grad", "causal", "decode read"):
        picks = {}
        for d in (8, 64, 65, 96, 128, 129, 512, 513):
            shape = MixerShape(batch=8, heads=8, tokens=40000,
                               latents=1 if kind == "decode read" else 2048, head_dim=d)
            picks[d] = resolve_policy(None, shape, device="cuda",
                                      requires_grad=kind.endswith("grad"),
                                      causal=kind == "causal").backend
        print(f"resolve auto on cuda ({kind}): {picks}", flush=True)
        # the FLARE kernels take D up to 64, the causal one up to 128, the
        # paged one up to 512 (its MLA instance above 128)
        want = {"bidirectional, grad": {d: "packed" if d <= 64 else "sdpa" for d in picks},
                "causal": {d: "causal_pallas" if d <= 128 else "causal_stream" for d in picks},
                "decode read": {d: "paged" for d in picks if d <= 512}}[kind]
        got = {d: b for d, b in picks.items() if kind != "decode read" or d <= 512}
        if got != want or (kind == "decode read" and picks[513] == "paged"):
            checks.failures.append(f"resolve auto ({kind}): {picks}, expected {want}")
    checks.raise_failures("kernels at widened head dims")


def shard_pipeline(q, k, v, dy, cuts, *, lose=None):
    """The sharded mixer's four entry points over token slices ``cuts`` on
    one card, the ranks' collectives done by hand: each slice's statistics,
    merged by the plain merge (without slice ``lose``'s), a decode per slice,
    dZ summed over the slices, the gradients per slice. Returns {"stats":
    each slice's (num, mx, den) stacked over the slices, "y", "lse", "dz"
    (the sum), "grads": (dq, dk, dv)} over all the tokens; without ``dy``,
    y only."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare_packed_shard import (
        flare_enc_stats,
        flare_shard_decode,
        flare_shard_dz,
        flare_shard_grads,
    )

    parts = [slice(a, b) for a, b in zip(cuts, cuts[1:])]
    stats = [flare_enc_stats(q, k[:, :, s], v[:, :, s]) for s in parts]
    kept = [st for i, st in enumerate(stats) if i != lose]
    z, mx, den = ref.combine_stats_ref(*(torch.stack(t) for t in zip(*kept)))
    del kept
    dec = [flare_shard_decode(q, k[:, :, s], z) for s in parts]
    y = torch.cat([yy for yy, _ in dec], dim=2)
    if dy is None:
        return y
    dz = sum(flare_shard_dz(q, k[:, :, s], lse, dy[:, :, s]) for s, (_, lse) in zip(parts, dec))
    grads = [flare_shard_grads(q, k[:, :, s], v[:, :, s], z, mx, den, lse, yy, dy[:, :, s], dz)
             for s, (yy, lse) in zip(parts, dec)]
    dq = sum(g[0] for g in grads)
    dk, dv = (torch.cat([g[i] for g in grads], dim=2) for i in (1, 2))
    return dict(stats=tuple(torch.stack(t) for t in zip(*stats)), y=y,
                lse=torch.cat([lse for _, lse in dec], dim=2), dz=dz, grads=(dq, dk, dv))


def check_shard(checks: Checks, label: str, q, k, v, dy, y64, grads64) -> None:
    """The four entry points on block 0's own operands: on one slice against
    the fused kernels (bit-identical expected; a difference is printed and
    must be within 1e-6 of max |.|), and over SHARD_SLICES slices of the
    tokens emulated on the card, each against its plain version in fp64:
    each slice's statistics (num, mx, den) against ``flare_enc_stats_ref``
    on the widened slice, the summed dZ against ``flare_bwd_dz_ref`` on the
    pipeline's own lse, y (y64) and the gradients (grads64) against the
    plain forward and backward at the fused kernels' limits. num must reject
    its fp64 plain version with each slice's first token tile left out, dZ
    the one with the first token tile left out, and y the pipeline with
    slice 2's statistics left out of the merge.
    num, den and dZ are sums over a slice's or all the tokens, held relative
    to their size only."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd
    from repro_torch.kernels.flare_packed_shard import (
        combine_stats,
        flare_enc_stats,
        flare_shard_decode,
        flare_shard_dz,
        flare_shard_grads,
    )

    b, _, n, _ = k.shape
    print(f"kernels shard {label} (block 0's operands, N={n}; one slice against the fused "
          f"kernels, {SHARD_SLICES} slices against fp64):", flush=True)
    y, z, mx, den, lse = flare_fused_fwd(q, k, v)
    fused_grads = flare_fused_bwd(q, k, v, z, mx, den, lse, y, dy)
    zs, gmx, gden = combine_stats(*flare_enc_stats(q, k, v), None)
    ys, lses = flare_shard_decode(q, k, zs)
    dz = flare_shard_dz(q, k, lses, dy)
    grads = flare_shard_grads(q, k, v, zs, gmx, gden, lses, ys, dy, dz)
    diffs = {}
    for what, got, want in zip(("z", "max", "den", "y", "lse", *GRADS),
                               (zs, gmx, gden, ys, lses, *grads),
                               (z, mx, den, y, lse, *fused_grads)):
        d = max_err(got, want)
        diffs[what] = d
        if not d <= 1e-6 * want.abs().max().item():
            checks.failures.append(f"shard one slice {label} {what}: {d:.3g} off the fused kernels")
    same = all(d == 0 for d in diffs.values())
    print(f"  one slice vs fused: {'bit-identical' if same else diffs}", flush=True)
    del y, z, mx, den, lse, fused_grads, zs, gmx, gden, ys, lses, dz, grads
    cuts = [i * n // SHARD_SLICES for i in range(SHARD_SLICES + 1)]
    run = shard_pipeline(q, k, v, dy, cuts)
    f32, atol, tag = torch.float32, ATOL["float32"], f"{SHARD_SLICES} slices"
    q64, k64, v64, dy64 = (t.to(torch.float64) for t in (q, k, v, dy))
    parts = [slice(a, c) for a, c in zip(cuts, cuts[1:])]
    stats64 = [torch.stack(t) for t in zip(*(
        by_head(ref.flare_enc_stats_ref, q64, k64[:, :, s], v64[:, :, s]) for s in parts))]
    num_lost = torch.stack([by_head(ref.flare_enc_stats_ref, q64, k64[:, :, s][:, :, TILE:],
                                    v64[:, :, s][:, :, TILE:])[0] for s in parts])
    for what, got, want in zip(("num", "max", "den"), run["stats"], stats64):
        checks.hold("flare_enc_stats", f"{what} {tag}", got, want, f32,
                    atol=atol if what == "max" else None, record=True,
                    dropped={"token tile": num_lost} if what == "num" else None)
    del stats64, num_lost
    lse64 = run["lse"].to(torch.float64)
    chunk = bwd_chunk(b, q.shape[1])
    dz_plain = lambda qh, kh, lh, dyh: ref.flare_bwd_dz_ref(qh, kh, lh, dyh, chunk=chunk)
    dz_lost = by_head(lambda qh, kh, lh, dyh: dz_plain(qh, kh[:, :, TILE:], lh[:, :, TILE:],
                                                       dyh[:, :, TILE:]), q64, k64, lse64, dy64)
    checks.hold("flare_shard_dz", f"dZ {tag}", run["dz"], by_head(dz_plain, q64, k64, lse64, dy64),
                f32, atol=None, record=True, dropped={"token tile": dz_lost})
    del lse64, dz_lost
    lost = shard_pipeline(q, k, v, None, cuts, lose=2).double()
    checks.hold("flare_shard_decode", f"y {tag}", run["y"], y64, f32, atol=atol, record=True,
                dropped={"slice 2's statistics": lost})
    del lost
    for what, got, want in zip(GRADS, run["grads"], grads64):
        checks.hold("flare_shard_grads", f"{what} {tag}", got, want, f32,
                    atol=BWD_ATOL[what], record=True)
    checks.raise_failures(f"shard entry points at {label}")


def time_shard(q, k, v, dy) -> dict:
    """CUDA-event times of the four entry points on the main path's operands
    (one rank's tokens: all of them), their plain versions a head at a time,
    and the ``sdpa`` backend's SDPA calls for the same work, with each bound:
    the encode's SDPA, the decode's, the decode's backward into its value
    input alone (dZ), and the rest of the backward given dZ (the decode's
    backward into its query and key inputs and the encode's into all three:
    dq, dk and dv)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare_packed_shard import (
        combine_stats,
        flare_enc_stats,
        flare_shard_decode,
        flare_shard_dz,
        flare_shard_grads,
    )

    b, h, n, d = k.shape
    m = q.shape[1]
    z, mx, den = combine_stats(*flare_enc_stats(q, k, v), None)
    y, lse = flare_shard_decode(q, k, z)
    dz = flare_shard_dz(q, k, lse, dy)
    chunk = bwd_chunk(b, m)
    qb = q.expand(b, h, m, d)
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, scale=1.0)
    qe = q.detach().clone().requires_grad_(True)
    kk, vv, zz = (t.detach().clone().requires_grad_(True) for t in (k, v, z))
    y_dz = sdpa(k, qb, zz)   # only the value input takes a gradient
    lib_dz = lambda: torch.autograd.grad(y_dz, zz, dy, retain_graph=True)
    y_qk, z_qkv = sdpa(kk, qe.expand(b, h, m, d), z), sdpa(qe.expand(b, h, m, d), kk, vv)
    lib_grads = lambda: (torch.autograd.grad(y_qk, (qe, kk), dy, retain_graph=True),
                         torch.autograd.grad(z_qkv, (qe, kk, vv), dz, retain_graph=True))
    runs = {
        "flare_enc_stats": (lambda: flare_enc_stats(q, k, v),
                            lambda: by_head(ref.flare_enc_stats_ref, q, k, v),
                            lambda: sdpa(qb, k, v)),
        "flare_shard_decode": (lambda: flare_shard_decode(q, k, z),
                               lambda: by_head(ref.flare_decode_stats_ref, q, k, z),
                               lambda: sdpa(k, qb, z)),
        "flare_shard_dz": (lambda: flare_shard_dz(q, k, lse, dy),
                           lambda: by_head(lambda *a: ref.flare_bwd_dz_ref(*a, chunk=chunk),
                                           q, k, lse, dy), lib_dz),
        "flare_shard_grads": (lambda: flare_shard_grads(q, k, v, z, mx, den, lse, y, dy, dz),
                              lambda: by_head(lambda qh, kh, vh, zh, mh, dh, lh, yh, dyh, dzh:
                                              ref.flare_bwd_grads_ref(qh, kh, vh, zh, mh, dh, lh,
                                                                      yh, dyh, dzh, chunk=chunk),
                                              q, k, v, z, mx, den, lse, y, dy, dz), lib_grads),
    }
    f4, mnd, bhn, bhm = 4, b * h * m * n * d, b * h * n, b * h * m
    qkv = f4 * (h * m * d + 2 * bhn * d)
    work = {   # (FLOP, bytes): each input read once, each output written once
        # the scores and the numerator: two products; out num, mx, den
        "flare_enc_stats": (2 * 2 * mnd, qkv + f4 * bhm * (d + 2)),
        # the scores and y: two products; in q, k, z; out y, lse
        "flare_shard_decode": (2 * 2 * mnd, f4 * (h * m * d + bhn * d + bhm * d + bhn * (d + 1))),
        # the scores and dZ: two products; in q, k, dy, lse; out dZ
        "flare_shard_dz": (2 * 2 * mnd, f4 * (h * m * d + 2 * bhn * d + bhn + bhm * d)),
        # S, dA, dW, dk, dv, dq: six products; in q, k, v, y, dy, lse, z, dZ,
        # mx, den; out dq, dk, dv
        "flare_shard_grads": (6 * 2 * mnd,
                              f4 * (2 * h * m * d + 6 * bhn * d + bhn + bhm * (2 * d + 2))),
    }
    stats = {}
    for name, (kern, plain, lib) in runs.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BW * 1e3
        stats[name] = dict(
            ms=cuda_ms(kern, reps=5), plain_ms=cuda_ms(plain, reps=1, warmup=0),
            library_ms=cuda_ms(lib, reps=3), bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    del y_dz, y_qk, z_qkv
    return stats


SHARD_KERNELS = ("flare_enc_stats", "flare_shard_decode", "flare_shard_dz", "flare_shard_grads")


def train_sharded(cfg, s40, s1m) -> dict:
    """The slice's main path: ``Trainer.fit`` of ``get_model(flare_pde)``
    under the ``packed_shard`` plan on a mesh over an NCCL process group of
    one rank, 5 steps at pde_40k against 5 steps of the ``packed`` plan from
    the same seed and batches, then 2 steps at pde_1m. Launch counts and
    collectives zeroed just before each fit and read just after."""
    import torch
    import torch.distributed as dist

    from repro_torch.backends.packed_shard import mesh_shape_tag
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.data.pde_data import darcy_batch, pointcloud_batch
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import shard_tokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model

    compat.init("cuda", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device_type="cuda")
        model = get_model(cfg, policy=MixerPolicy(backends=("packed_shard",)), mesh=mesh)
        plan = model.plans["train"].describe()
        print(f"train sharded {cfg.name}: {dist.get_backend()} group of "
              f"{dist.get_world_size()}, mesh {mesh_shape_tag(mesh)}; plans {{train: {plan}, "
              f"infer: {model.plans['infer'].describe()}}}", flush=True)
        if not plan.startswith("packed_shard"):
            raise AssertionError(f"train plan {plan} is not the sharded kernels")
        steps = SHARDED_STEPS
        batches = [pointcloud_batch(SEED, 200 + i, s40.global_batch, grid=256,
                                    num_points=s40.seq_len) for i in range(steps)]
        runs = {}
        for name, mdl, msh in (("packed_shard", model, mesh),
                               ("packed", get_model(cfg, policy=MixerPolicy(backends=("packed",))),
                                None)):
            runs[name] = fit_counted(mdl, msh, lambda i: batches[i], steps)
        sh, pk = runs["packed_shard"], runs["packed"]
        per_step = sh["per_step"]
        for i, c in enumerate(per_step):
            print(f"train sharded pde_40k step {i + 1}: launches {launched(c)}, all-reduce "
                  f"{c['calls']} calls {c['bytes'] / 1e6:.3f} MB, {sh['ms'][i]:.3f} ms (packed "
                  f"{pk['ms'][i]:.3f} ms)", flush=True)
        loss_diff = max(abs(a - b) for a, b in zip(sh["loss"], pk["loss"]))
        param_diff = max((sh["params"][key] - p).abs().max().item()
                         for key, p in pk["params"].items())
        ms_sh, ms_pk = (sum(r["ms"][2:]) / len(r["ms"][2:]) for r in (sh, pk))
        print(f"train sharded pde_40k: losses {sh['loss']}, packed {pk['loss']}; max loss diff "
              f"{loss_diff:.3g}, parameters max abs diff {param_diff:.3g} (limit {SHARD_TOL:g}); "
              f"{ms_sh:.3f} ms/step (mean of steps 3-{steps}; packed {ms_pk:.3f}), peak "
              f"{sh['peak']:.2f} GiB (packed {pk['peak']:.2f})", flush=True)
        nb = cfg.num_layers
        for c in per_step:
            if not (all(c["launches"][k] == nb for k in SHARD_KERNELS)
                    and c["launches"]["flare_fused_fwd"] == c["launches"]["flare_fused_bwd"] == 0):
                raise AssertionError(f"sharded train step launches {c['launches']}")
            if c["calls"] == 0:
                raise AssertionError("the sharded train step issued no collective")
        if not (loss_diff <= SHARD_TOL and param_diff <= SHARD_TOL):
            raise AssertionError("the sharded training path differs from the packed path")
        trainer = sh["trainer"]
        local = shard_tokens(batches[0], mesh)
        prof = breakdown(lambda: trainer._train_step(trainer.net, trainer.opt_state, local),
                         "train sharded pde_40k step", top=12)
        if prof is not None:
            # on a group of one NCCL launches no kernel of its own: its
            # all-reduce is a device-to-device copy
            comm = {key: ms for key, ms in prof[0].items()
                    if "nccl" in key.lower() or "memcpy" in key.lower()}
            total = sum(prof[0].values())
            print(f"breakdown train sharded pde_40k step: NCCL kernels and device copies "
                  f"{sum(comm.values()):.3f} ms of {total:.3f} ms device time "
                  f"({100 * sum(comm.values()) / total:.2f}%): {comm}", flush=True)
        # each collective of the step alone, at its size (CUDA events)
        group = compat.axis_group(mesh, "data")
        rows = s40.global_batch * cfg.flare_heads * cfg.flare_latents
        d = cfg.d_model // cfg.flare_heads
        params = sum(p.numel() for p in trainer.net.parameters())
        for label, n, op in (("SUM of num and den", rows * (d + 1), compat.all_reduce_sum_),
                             ("MAX of mx", rows, compat.all_max),
                             ("SUM of dZ", rows * d, compat.all_reduce_sum_),
                             ("SUM of the gradients", params, compat.all_reduce_sum_)):
            buf = torch.randn(n, device=trainer.device)
            print(f"collective {label}, {4 * n / 1e6:.3f} MB on the group of one: "
                  f"{cuda_ms(lambda: op(buf, group), reps=20):.4f} ms", flush=True)
        del runs, sh, pk, trainer, batches
        torch.cuda.empty_cache()
        b1m = darcy_batch(SEED, 1, s1m.global_batch, grid=int(math.isqrt(s1m.seq_len)))
        big = fit_counted(model, mesh, lambda i: b1m, SHARDED_STEPS_1M)
        print(f"train sharded pde_1m B={s1m.global_batch} N={s1m.seq_len}: ms/step "
              f"{[round(t, 3) for t in big['ms']]}, peak {big['peak']:.2f} GiB, losses "
              f"{big['loss']}, launches a step {[launched(c) for c in big['per_step']]}, "
              f"all-reduce a step {[(c['calls'], c['bytes']) for c in big['per_step']]}",
              flush=True)
        for c in big["per_step"]:
            if not all(c["launches"][k] == nb for k in SHARD_KERNELS):
                raise AssertionError(f"pde_1m sharded launches {c['launches']}")
        if not all(math.isfinite(x) for x in big["loss"]):
            raise AssertionError(f"pde_1m sharded losses {big['loss']}")
        return {k: sum(c["launches"][k] for c in per_step + big["per_step"])
                for k in SHARD_KERNELS}
    finally:
        dist.destroy_process_group()


def launched(window: dict) -> dict:
    """The kernels a counted window launched, with their counts."""
    return {name: n for name, n in window["launches"].items() if n}


def fit_counted(model, mesh, batch_fn, steps: int) -> dict:
    """``Trainer.fit`` for ``steps`` from seed 0 into a temporary checkpoint
    directory, with the kernel launches and collectives of each step (read
    when the next step asks for its batch, and after the fit), ms per step,
    losses, peak GiB and the parameters after."""
    import tempfile

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.distributed import compat
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.train import Trainer

    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = TrainConfig(steps=steps, learning_rate=TRAIN_LR, seed=SEED,
                           checkpoint_every=1000, checkpoint_dir=ckdir, log_every=1000)
        trainer = Trainer(model, tcfg, mesh)
        per_step = []

        def snapshot():
            per_step.append(dict(launches=launch_counts(), **compat.COUNTS))
            reset_launch_counts()
            compat.reset_counts()

        def fed(i):
            if i:
                snapshot()
            return batch_fn(i)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        compat.reset_counts()
        history = trainer.fit(fed)
        snapshot()
        peak = torch.cuda.max_memory_allocated() / 2**30
    # the last step's window also holds the fit's closing barrier (uncounted)
    return dict(loss=[h["loss"] for h in history], ms=[1e3 * h["time"] for h in history],
                grad_norm=[h["grad_norm"] for h in history],
                params={k: p.detach().clone() for k, p in trainer.net.named_parameters()},
                per_step=per_step, peak=peak, trainer=trainer)


# each rank of the two-rank check: a gloo group on the one card (NCCL takes
# one rank a card), the packed_shard plan on a (2, 1) mesh, Trainer.fit on
# its half of every example's tokens; it saves what the parent compares
TWO_RANK_CODE = r"""
import os, sys
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ["SRC"])
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.policy import MixerPolicy
from repro_torch.data.pde_data import pointcloud_batch
from repro_torch.distributed.compat import COUNTS, make_mesh
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.api import get_model
from repro_torch.train import Trainer

rank, out = int(os.environ["RANK"]), os.environ["OUT"]
seed, steps, lr = int(os.environ["SEED"]), int(os.environ["STEPS"]), float(os.environ["LR"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=2)
probe = torch.ones(4, device="cuda")
dist.all_reduce(probe)
mesh = make_mesh((2, 1), ("data", "model"), device_type="cuda")
model = get_model(get_config("flare_pde"), policy=MixerPolicy(backends=("packed_shard",)),
                  mesh=mesh)
batches = [pointcloud_batch(seed, 300 + i, 2, grid=128, num_points=4096) for i in range(steps)]
tcfg = TrainConfig(steps=steps, learning_rate=lr, seed=seed, checkpoint_every=1000,
                   checkpoint_dir=os.path.join(out, "ckpt"), log_every=1000)
trainer = Trainer(model, tcfg, mesh)
history = trainer.fit(lambda i: batches[i])
torch.save(dict(probe=probe.cpu(), plan=model.plans["train"].describe(),
                loss=[h["loss"] for h in history], grad_norm=[h["grad_norm"] for h in history],
                params={k: p.detach().cpu() for k, p in trainer.net.named_parameters()},
                launches=launch_counts(), collectives=dict(COUNTS)),
           os.path.join(out, f"rank{rank}.pt"))
dist.destroy_process_group()
"""
TWO_RANK_STEPS = 3


def train_two_ranks(cfg) -> None:
    """The cross-rank path on the card: two ranks of a gloo group sharing the
    one card train under ``packed_shard`` (each rank half of every
    example's tokens) for TWO_RANK_STEPS steps at B=2, N=4,096, against the
    ``packed`` path in this process from the same weights and batches: loss
    and grad_norm per step (1e-4), parameters after (PARAM_TOL_LR x lr), the
    ranks' parameters equal to each other, 8 launches of each shard entry
    point a step on each rank. The ranks' launches are a comparison's, not
    counted in the kernels line."""
    import os
    import tempfile

    import torch

    from repro_torch.core.policy import MixerPolicy
    from repro_torch.data.pde_data import pointcloud_batch
    from repro_torch.models.api import get_model

    steps = TWO_RANK_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, SRC=str(SRC), WORLD_SIZE="2", INIT=f"file://{tmp}/rendezvous",
                   OUT=tmp, SEED=str(SEED), STEPS=str(steps), LR=str(TRAIN_LR))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", TWO_RANK_CODE], env=dict(env, RANK=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"two-rank training, rank {r} exited {p.returncode}:\n"
                                     f"{log[-4000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    seconds = time.perf_counter() - t0
    batches = [pointcloud_batch(SEED, 300 + i, 2, grid=128, num_points=4096) for i in range(steps)]
    ref = fit_counted(get_model(cfg, policy=MixerPolicy(backends=("packed",))), None,
                      lambda i: batches[i], steps)
    r0 = ranks[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], ref["loss"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["grad_norm"],
                                                        [float(x) for x in ref["grad_norm"]]))
    param_err = max((r0["params"][k] - p.cpu()).abs().max().item()
                    for k, p in ref["params"].items())
    same = all(torch.equal(r0["params"][k], ranks[1]["params"][k]) for k in r0["params"])
    print(f"train two ranks (gloo, one card) {r0['plan']} B=2 N=4096, {steps} steps in "
          f"{seconds:.1f} s with start-up: losses {r0['loss']}, packed {ref['loss']}; loss rel "
          f"{loss_rel:.3g}, grad_norm rel {gnorm_rel:.3g} (limit {TRAIN_TOL:g}), parameters max "
          f"abs diff {param_err:.3g} (limit {PARAM_TOL_LR * TRAIN_LR:g}), ranks' parameters equal "
          f"{same}; launches {[launched(dict(launches=r['launches'])) for r in ranks]}, "
          f"all-reduce {[(r['collectives']['calls'], r['collectives']['bytes']) for r in ranks]}",
          flush=True)
    want = steps * cfg.num_layers
    if not all(r["launches"][k] == want for r in ranks for k in SHARD_KERNELS):
        raise AssertionError(f"two-rank launches {[r['launches'] for r in ranks]}")
    if not (same and loss_rel <= TRAIN_TOL and gnorm_rel <= TRAIN_TOL
            and param_err <= PARAM_TOL_LR * TRAIN_LR):
        raise AssertionError("two ranks on the card differ from the packed path")


# --------------------------------------------------------------------------
# The causal FLARE LM (flare_lm): the causal kernel, forward, prefill, decode
# --------------------------------------------------------------------------


def check_causal_small(checks: Checks, device) -> None:
    """The causal kernel against its plain version on random operands: bf16
    at flare_lm's width, and a ragged shape (T=97, M=16, D=8) in both dtypes;
    the full-width bf16 output (the tensor cores) also beyond bf16's output
    rounding against the plain version in fp64 on the same bf16 values
    (Checks.hold_rounded), which must reject one 64-token kernel tile left
    out of the carried state at T/2; then at the head dims it runs at a
    padded width (CAUSAL_WIDE: 24, 40 and phi3's 96), fp32 against the plain
    version in fp64 (tile 256) with a limit that must reject one 64-token
    kernel tile left out of the carried state, and bf16 against the plain
    version. Last, the kernel's bf16 time at flare_lm's width (H=16, M=512,
    T=8,192) at D=96 beside D=128."""
    import torch

    from repro_torch.kernels.flare_causal import TILE, flare_causal_chunk
    from repro_torch.kernels.ref import flare_causal_chunk_ref

    gen = torch.Generator().manual_seed(SEED + 2)
    plain64 = lambda qh, kh, vh: flare_causal_chunk_ref(qh, kh, vh, tile=256)
    for shape_name, s in CAUSAL_SMALL.items():
        for dtype in ((torch.bfloat16,) if shape_name.startswith("bf16")
                      else (torch.float32, torch.bfloat16)):
            q, k, v = inputs(s, dtype, gen, device)
            print(f"kernels causal {shape_name} {s} {dtype}:", flush=True)
            got = flare_causal_chunk(q, k, v)
            checks.hold("flare_causal_chunk", "y", got, flare_causal_chunk_ref(q, k, v), dtype,
                        atol=ATOL[str(dtype).removeprefix("torch.")],
                        record=dtype == torch.float32)
            if shape_name.startswith("bf16"):
                wide = [t.double() for t in (q, k, v)]
                t0 = s["n"] // 2 // TILE * TILE
                checks.hold_rounded("flare_causal_chunk", "y bf16 vs fp64", got, plain64(*wide),
                                    dropped={"state tile": drop_tile(plain64, t0, TILE)(*wide)})
                del wide
    for d, s in CAUSAL_WIDE.items():
        print(f"kernels causal D={d} {s} (fp32 against the plain version in fp64):", flush=True)
        q, k, v = inputs(s, torch.float32, gen, device)
        wide = [t.double() for t in (q, k, v)]
        t0 = s["n"] // 2 // TILE * TILE
        checks.hold("flare_causal_chunk", f"y fp32 D={d}", flare_causal_chunk(q, k, v),
                    plain64(*wide), torch.float32, atol=ATOL["float32"], record=True,
                    fp32_plain=flare_causal_chunk_ref(q, k, v),
                    dropped={"state tile": drop_tile(plain64, t0, TILE)(*wide)})
        q, k, v = (t.bfloat16() for t in (q, k, v))
        checks.hold("flare_causal_chunk", f"y bf16 D={d}", flare_causal_chunk(q, k, v),
                    flare_causal_chunk_ref(q, k, v), torch.bfloat16, atol=ATOL["bfloat16"])
    checks.raise_failures("causal kernel on random operands")
    times = {}
    for d in (96, 128):
        q, k, v = inputs(dict(CAUSAL_SMALL["bf16 full width"], d=d), torch.bfloat16, gen, device)
        times[d] = cuda_ms(lambda: flare_causal_chunk(q, k, v), reps=5)
    print(f"time flare_causal_chunk bf16 B=1 H=16 M=512 T=8192: D=96 {times[96]:.3f} ms, "
          f"D=128 {times[128]:.3f} ms", flush=True)


def lm_operands(net, cfg, tokens, dtype):
    """q, k, v as layer 0's mixer receives them for ``tokens``, computed in
    ``dtype`` by the model's own embed, norm and k/v functions: the main
    path's own operands, k and v strided split-head views."""
    import torch

    from repro_torch.config import replace
    from repro_torch.models import transformer

    cfg = replace(cfg, compute_dtype=str(dtype).removeprefix("torch."))
    with torch.no_grad():
        layer = net.layers[0]
        x = transformer._norm(cfg, layer.norm1, transformer._embed(net, tokens, cfg))
        k, v = transformer._kv(layer.attn, x, cfg.attn.num_heads)
        return layer.attn.q_latent.detach().to(dtype), k, v


def drop_tile(fn, t0: int, width: int):
    """``fn`` (a plain causal version) with tokens [t0, t0 + width) left out
    of the carried state of every later token: what a kernel that lost one
    tile of its state would give."""
    import torch

    def dropped(q, k, v):
        y = fn(q, k, v)
        rest = fn(q, torch.cat([k[:, :, :t0], k[:, :, t0 + width:]], 2),
                  torch.cat([v[:, :, :t0], v[:, :, t0 + width:]], 2))
        y[:, :, t0 + width:] = rest[:, :, t0:]
        return y

    return dropped


def check_causal_main(checks: Checks, ops32, ops16) -> None:
    """The causal kernel on layer 0's own operands: fp32 against the plain
    version in fp64 (tile 256), a head at a time, relative to max |plain|;
    the limit must reject the fp64 plain version with one 64-token kernel
    tile left out of the carried state (the tile at T/2). bf16 against the
    plain version on the same bf16 operands, and beyond bf16's output
    rounding against the plain version in fp64 on those bf16 values
    (Checks.hold_rounded), which must reject the same lost tile."""
    import torch

    from repro_torch.kernels.flare_causal import TILE, flare_causal_chunk
    from repro_torch.kernels.ref import flare_causal_chunk_ref

    q, k, v = ops32
    b, h, n, d = k.shape
    print(f"kernels causal flare_lm layer 0 (B={b} H={h} M={q.shape[1]} T={n} D={d}, k/v "
          f"strides {k.stride()}; fp32 held against the plain version in fp64):", flush=True)
    plain64 = lambda qh, kh, vh: flare_causal_chunk_ref(qh, kh, vh, tile=256)
    wide = [t.to(torch.float64) for t in ops32]
    want = by_head(plain64, *wide)
    checks.hold("flare_causal_chunk", "y fp32", flare_causal_chunk(q, k, v), want,
                torch.float32, atol=None, record=True,
                fp32_plain=by_head(flare_causal_chunk_ref, q, k, v),
                dropped={"state tile": by_head(drop_tile(plain64, n // 2, TILE), *wide)})
    del want, wide
    q, k, v = ops16
    got = flare_causal_chunk(q, k, v)
    checks.hold("flare_causal_chunk", "y bf16", got, by_head(flare_causal_chunk_ref, q, k, v),
                torch.bfloat16, atol=None)
    # beyond bf16's output rounding against fp64 on the same bf16 values: the
    # 1e-2 above cannot see a lost state tile at this T
    wide = [t.to(torch.float64) for t in ops16]
    checks.hold_rounded("flare_causal_chunk", "y bf16 vs fp64", got, by_head(plain64, *wide),
                        dropped={"state tile": by_head(drop_tile(plain64, n // 2, TILE), *wide)})
    checks.raise_failures("causal kernel on flare_lm's operands")


def time_causal(q, k, v) -> dict:
    """CUDA-event times of the causal kernel and its plain version on the same
    operands, with the bound: 3 products of 2*B*H*M*T*D FLOP (scores, state
    update, decode) over the peak for the operands' type (bf16: the tensor
    cores' 989 TFLOP/s; fp32: 67 TFLOP/s), or q, k, v and y once over 3.35 TB/s."""
    import torch

    from repro_torch.kernels.flare_causal import flare_causal_chunk
    from repro_torch.kernels.ref import flare_causal_chunk_ref

    b, h, n, d = k.shape
    m = q.shape[1]
    size = k.element_size()
    flops = 3 * 2 * b * h * m * n * d
    nbytes = size * (h * m * d + 3 * b * h * n * d)
    peak = PEAK_BF16 if k.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BW * 1e3
    stats = dict(ms=cuda_ms(lambda: flare_causal_chunk(q, k, v), reps=5),
                 plain_ms=cuda_ms(lambda: flare_causal_chunk_ref(q, k, v), reps=1),
                 library_ms=None, bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    if k.dtype == torch.bfloat16:
        stats.update(causal_tc_floors(b, h, m, n, d))
    else:
        stats.update(kernel="causal_tf32_kernel", **causal_tf32_floors(b, h, m, n, d))
    return stats


def causal_tc_floors(b: int, h: int, m: int, n: int, d: int) -> dict:
    """The floors of the causal kernel's tensor-core design
    (csrc/flare_causal.cu, causal_tc_kernel) on its own work: per 64-latent
    slice and 64-token tile, the products as it issues them at the bf16
    peak (S; f1 v in two parts; f2^T num in three; f2^T f1 in three and a v
    in two over the token tiles up to each warp's own, 10 of 16 16 x 16
    blocks), its two exps a (latent, token) pair (f1 and the decode weight)
    at 16 a clock an SM at the card's top SM clock, and the bytes of its
    fp32 partials written and read back by the combine."""
    cl = ct = 64
    dp = max(16, 1 << (d - 1).bit_length())
    tiles, slices = -(-n // ct), -(-m // cl)
    per_tile = (2 * cl * ct * dp * (1 + 2 + 3)          # S, f1 v, f2^T num
                + 2 * cl * 16 * 16 * 10 * 3              # f2^T f1, the causal blocks
                + 2 * 16 * 16 * 10 * dp * 2)             # a v
    sm_hz = max_sm_clock_mhz() * 1e6
    return dict(
        floor_products_ms=b * h * slices * tiles * per_tile / PEAK_BF16 * 1e3,
        floor_exps_ms=2 * b * h * m * n / (16 * 132 * sm_hz) * 1e3,
        floor_partials_ms=2 * 4 * slices * b * h * n * (d + 2) / PEAK_BW * 1e3)


def causal_tf32_floors(b: int, h: int, m: int, n: int, d: int) -> dict:
    """The floors of the causal kernel's fp32 design (csrc/flare_causal.cu,
    causal_tf32_kernel) on its own work: per 64-latent slice and 32-token
    tile, every product three TF32 MMAs as it issues them at the TF32 peak
    (S, f1 v and f2^T num over the whole tile; the mixing f2^T f1 over the
    token tiles up to each warp's own, 3 of 4 16 x 16 blocks, computed by
    each of the 4 warps of a token tile; a v over the same blocks), its two
    exps a (latent, token) pair and the bytes of its fp32 partials, as
    causal_tc_floors."""
    cl, ct = 64, 32
    dp = max(32, 1 << (d - 1).bit_length())
    tiles, slices = -(-n // ct), -(-m // cl)
    blocks = 16 * 16 * 3                                  # the causal token pairs' blocks
    per_tile = 3 * (3 * 2 * cl * ct * dp                  # S, f1 v, f2^T num
                    + 4 * 2 * blocks * cl                 # f2^T f1, four warps each
                    + 2 * blocks * dp)                    # a v
    floors = causal_tc_floors(b, h, m, n, d)
    return dict(floor_products_ms=b * h * slices * tiles * per_tile / PEAK_TF32 * 1e3,
                floor_exps_ms=floors["floor_exps_ms"],
                floor_partials_ms=floors["floor_partials_ms"])


def held(label: str, got, want, tol: float) -> None:
    """Logits of a kernel path against a plain (or reference) path: max abs
    difference over max |want|."""
    err, scale = max_err(got, want), want.abs().max().item()
    print(f"{label}: max|ref| {scale:.4g}, max abs diff {err:.4g}, rel {err / scale:.3g} "
          f"(limit {tol:g})", flush=True)
    if not (math.isfinite(err) and err <= tol * scale):
        raise AssertionError(f"{label}: rel {err / scale:.3g} above {tol:g}")


def lm_forward(cfg, model, net, tokens) -> dict:
    """Model.forward at B=1, T=32,768 in bf16 through the causal kernel: one
    counted window of a warm-up and two timed forwards (24 launches each),
    peak GiB, a profiler breakdown; then held against the plain causal_stream
    path in bf16. In fp32 compute one forward is a counted window of its own
    (24 launches on the fp32 route), traced on the device (its ms, and its
    kernels must name causal_tf32_kernel, never causal_tc_kernel), and held
    against the plain path in fp32."""
    import torch

    from repro_torch.config import replace
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model

    batch = {"tokens": tokens}
    b, n = tokens.shape
    reps = 2
    reset_launch_counts()
    (logits, _), ms, peak = forward_ms(model, net, batch, reps)
    counts = launch_counts()
    print(f"path flare_lm causal_pallas B={b} T={n} bf16: {ms:.3f} ms/forward, peak {peak:.2f} "
          f"GiB, logits {tuple(logits.shape)} {logits.dtype}; launches over {reps + 1} forwards "
          f"{counts}", flush=True)
    if not (counts["flare_causal_chunk"] == (reps + 1) * cfg.num_layers
            and all(counts[name] == 0 for name in PDE_KERNELS)):
        raise AssertionError(f"flare_lm forward launches {counts}")
    if tuple(logits.shape) != (b, n, cfg.vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"flare_lm logits {tuple(logits.shape)} not finite or mis-shaped")
    seen = breakdown(lambda: model.forward(net, batch), f"flare_lm forward B={b} T={n} bf16")
    # bf16 goes to the bf16 kernel, never the fp32 route's
    assert_route(seen, f"flare_lm forward B={b} T={n} bf16", ("causal_tc_kernel",),
                 refuse=("causal_tf32_kernel",))
    plain = get_model(cfg, policy=MixerPolicy(backends=("causal_stream",)))
    t0 = time.perf_counter()
    want, _ = plain.forward(net, batch)
    torch.cuda.synchronize()
    print(f"path flare_lm causal_stream (plain) B={b} T={n} bf16: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (one forward)", flush=True)
    held("flare_lm forward causal_pallas vs causal_stream bf16", logits, want, LM_TOL["bfloat16"])
    del logits, want
    cfg32 = replace(cfg, compute_dtype="float32")
    model32 = get_model(cfg32)
    reset_launch_counts()
    (got, _), (prof, wall_ms) = traced(lambda: model32.forward(net, batch))
    counts32 = launch_counts()
    label = f"flare_lm forward B={b} T={n} fp32"
    print(f"path flare_lm causal_pallas B={b} T={n} fp32: {wall_ms:.3f} ms (one forward, traced "
          f"on the device); launches {counts32}", flush=True)
    if not (counts32["flare_causal_chunk"] == cfg.num_layers
            and all(counts32[name] == 0 for name in PDE_KERNELS)):
        raise AssertionError(f"flare_lm fp32 forward launches {counts32}")
    # fp32 goes to the TF32 kernel, never the bf16 route's
    assert_route(report(prof, wall_ms, label), label, ("causal_tf32_kernel",),
                 refuse=("causal_tc_kernel",))
    del prof
    want, _ = get_model(cfg32, policy=MixerPolicy(backends=("causal_stream",))).forward(net, batch)
    held("flare_lm forward causal_pallas vs causal_stream fp32", got, want, LM_TOL["float32"])
    del got, want
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": ms, "peak": peak, "ms_fp32": wall_ms,
            "launches_fp32": counts32["flare_causal_chunk"]}


def serve(model, net, batch, steps: int) -> dict:
    """Prefill then ``steps`` greedy decode steps; host clock around
    synchronized work. Returns the prefill and per-step logits, the tokens
    generated (the first from the prefill), and the times."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(net, batch, BUCKET + steps)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    outs, toks = [logits], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, caches = model.decode_step(net, toks[-1][:, None], caches)
        outs.append(logits)
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"logits": torch.stack(outs, 1), "tokens": torch.stack(toks, 1),
            "prefill_ms": prefill_ms, "step_ms": decode_s * 1e3 / steps,
            "tok_s": batch["tokens"].shape[0] * steps / decode_s, "pos": caches.pos}


def reference_logits(model, net, prompts, lengths, generated):
    """Model.forward on each request's prompt followed by the tokens it
    generated (right-padded to one length; causality keeps every real
    position exact), read at the positions the prefill and the decode steps
    predicted from: [R, steps + 1, V]."""
    import torch

    r, steps = generated.shape[0], generated.shape[1] - 1
    seqs = torch.zeros(r, int(lengths.max()) + steps, dtype=torch.long, device=prompts.device)
    for i in range(r):
        n = int(lengths[i])
        seqs[i, :n] = prompts[i, :n]
        seqs[i, n:n + steps] = generated[i, :steps]
    logits, _ = model.forward(net, {"tokens": seqs})
    pos = lengths[:, None] - 1 + torch.arange(steps + 1, device=prompts.device)[None, :]
    return logits[torch.arange(r, device=prompts.device)[:, None], pos]


def lm_requests(cfg, model, net, device) -> dict:
    """4 TokenStream prompts of 1,024-2,048 tokens in one 2,048 bucket with
    lengths: prefill and 64 greedy decode steps in bf16 (one counted window),
    then the same in fp32 compute held against Model.forward (the kernel
    path) on the prompts and the tokens generated; then the 4 prompts
    served by ServeEngine's dense pool by graph replay, held against its
    eager step in bf16 and fp32."""
    import numpy as np
    import torch

    from repro_torch.config import replace
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model

    rng = np.random.default_rng(SEED)
    lengths = np.sort(rng.integers(BUCKET // 2, BUCKET + 1, REQUESTS))
    toks = TokenStream(cfg.vocab, BUCKET, seed=SEED).batch(1, 0, 1, REQUESTS)["tokens"]
    toks[np.arange(BUCKET)[None, :] >= lengths[:, None]] = 0
    batch = {"tokens": torch.from_numpy(toks).long().to(device),
             "lengths": torch.from_numpy(lengths).to(device)}
    serve(model, net, batch, 2)                       # warm-up
    reset_launch_counts()
    run16 = serve(model, net, batch, DECODE_STEPS)
    counts = launch_counts()
    print(f"requests flare_lm bf16: {REQUESTS} prompts of {lengths.tolist()} tokens in a "
          f"{BUCKET} bucket: prefill {run16['prefill_ms']:.3f} ms, decode "
          f"{run16['step_ms']:.3f} ms/step over {DECODE_STEPS} steps ({run16['tok_s']:.1f} "
          f"tokens/s), positions after {run16['pos'].tolist()}; launches {counts}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"prefill and decode are plain torch, yet launched {counts}")
    if not (bool(run16["logits"].isfinite().all())
            and run16["pos"].tolist() == (lengths + DECODE_STEPS).tolist()):
        raise AssertionError("bf16 requests: non-finite logits or wrong positions")
    _, caches = model.prefill(net, batch, BUCKET + 1)
    breakdown(lambda: model.decode_step(net, run16["tokens"][:, :1], caches),
              f"flare_lm decode step B={REQUESTS} bf16")
    del caches
    ref16 = reference_logits(model, net, batch["tokens"], batch["lengths"], run16["tokens"])
    err16 = max_err(run16["logits"], ref16) / ref16.abs().max().item()
    same16 = (ref16.argmax(-1) == run16["tokens"]).float().mean().item()
    print(f"requests bf16 vs Model.forward bf16 (printed, not held): rel {err16:.3g}, greedy "
          f"tokens equal {100 * same16:.1f}%", flush=True)
    del ref16
    model32 = get_model(replace(cfg, compute_dtype="float32"))
    run32 = serve(model32, net, batch, DECODE_STEPS)
    ref32 = reference_logits(model32, net, batch["tokens"], batch["lengths"], run32["tokens"])
    print(f"requests flare_lm fp32: prefill {run32['prefill_ms']:.3f} ms, decode "
          f"{run32['step_ms']:.3f} ms/step", flush=True)
    held(f"requests fp32 prefill + {DECODE_STEPS} decode steps vs Model.forward (kernel path)",
         run32["logits"], ref32, LM_TOL["float32"])
    if not torch.equal(ref32.argmax(-1), run32["tokens"]):
        raise AssertionError("fp32 greedy tokens differ from Model.forward's argmax")
    print(f"requests fp32: the greedy tokens of all {REQUESTS} x {DECODE_STEPS + 1} positions "
          "equal Model.forward's", flush=True)
    # the same prompts through ServeEngine's dense pool, by graph replay
    # against the eager step, in bf16 and fp32 compute
    reqs = [(toks[i, :n].astype(np.int32), DECODE_STEPS) for i, n in enumerate(lengths)]
    base = dict(slots=REQUESTS, capacity=BUCKET + DECODE_STEPS)
    for dtype, m in (("bfloat16", model), ("float32", model32)):
        label = f"{'bf16' if dtype == 'bfloat16' else 'fp32'} dense"
        graph = serve_run(m, net, reqs, label, base=base, profile=True)
        graph_held(f"flare_lm {label}", graph,
                   serve_run(m, net, reqs, label, base=base, profile=True, graph=False), dtype)
        if dtype == "float32":
            same = np.mean([a == b for g, r in zip(graph["tokens"], run32["tokens"].tolist())
                            for a, b in zip(g, r)])
            print(f"serve flare_lm fp32 engine vs the batched prefill + decode above (printed, "
                  f"not held: one prefill a request against one of all four): greedy tokens "
                  f"equal {100 * same:.1f}%", flush=True)
    return {"counts": counts, **{key: run16[key] for key in ("prefill_ms", "step_ms", "tok_s")}}


def lm_phases(checks: Checks, device) -> dict:
    """The flare_lm slice: the causal kernel on random and on the model's own
    operands, Model.forward at T=32,768, and requests through prefill and
    decode. Returns the causal kernel's stats and the main-path windows'
    launch counts."""
    import numpy as np
    import torch

    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import get_model

    check_causal_small(checks, device)
    cfg = get_config("flare_lm")
    model = get_model(cfg)
    plan = model.plans["infer"]
    print(f"model {cfg.name}: plans {{infer: {plan.describe()}, train: "
          f"{model.plans['train'].describe()}}}", flush=True)
    if plan.backend != "causal_pallas":
        raise AssertionError(f"infer plan {plan.describe()} is not the causal kernel")
    t0 = time.perf_counter()
    net = card_init(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"init flare_lm: {time.perf_counter() - t0:.1f} s to draw {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB fp32) on the card", flush=True)
    n = SHAPES["prefill_32k"].seq_len
    t0 = time.perf_counter()
    tokens = torch.from_numpy(TokenStream(cfg.vocab, n, seed=SEED).batch(0, 0, 1, 1)["tokens"])
    tokens = tokens.long().to(device)
    print(f"data: TokenStream [1, {n}] in {time.perf_counter() - t0:.2f} s; distinct tokens "
          f"{len(np.unique(tokens.cpu().numpy()))}", flush=True)
    ops32 = lm_operands(net, cfg, tokens, torch.float32)
    ops16 = lm_operands(net, cfg, tokens, torch.bfloat16)
    check_causal_main(checks, ops32, ops16)
    stats = time_causal(*ops16)
    print(f"time flare_causal_chunk flare_lm layer 0 bf16: {stats}", flush=True)
    stats["fp32"] = time_causal(*ops32)
    print(f"time flare_causal_chunk flare_lm layer 0 fp32: {stats['fp32']}", flush=True)
    # the plain version is a loop of small eager ops per 64-token tile: its
    # device busy share says how far its time is the host's
    from repro_torch.kernels.ref import flare_causal_chunk_ref
    breakdown(lambda: flare_causal_chunk_ref(*ops16), "plain flare_causal_chunk bf16", top=3)
    del ops32, ops16
    torch.cuda.empty_cache()
    fwd = lm_forward(cfg, model, net, tokens)
    req = lm_requests(cfg, model, net, device)
    stats["fp32"].update(launches=fwd["launches_fp32"], forward_ms=fwd["ms_fp32"])
    stats["launches"] = (fwd["counts"]["flare_causal_chunk"] + req["counts"]["flare_causal_chunk"]
                         + fwd["launches_fp32"])
    del net
    torch.cuda.empty_cache()
    return stats


# --------------------------------------------------------------------------
# Training the LMs (flare_lm, qwen2-1.5b) at full width and depth: Model.loss
# -> autograd with per-layer activation checkpointing -> AdamW -> Trainer.fit
# on TokenStream batches
# --------------------------------------------------------------------------


def count_calls(module, name: str):
    """Replace ``module.name`` with a wrapper that counts its calls (the
    plain mixer functions the training route runs, which no kernel counter
    sees); returns the counter dict and an undo function."""
    fn, calls = getattr(module, name), {"n": 0}

    def counted(*args, **kw):
        calls["n"] += 1
        return fn(*args, **kw)

    setattr(module, name, counted)
    return calls, lambda: setattr(module, name, fn)


def lm_cross_entropy(logits, labels):
    """mean(logsumexp - gold) over fp32 logits [B, T, V] (a padded tail at
    -inf), in fp64."""
    logits = logits.double()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logits.logsumexp(-1) - gold).mean().item()


def served_logits(cfg, model, net, tokens):
    """The logits [B, T, vocab] of ``tokens`` from the serving forward
    kernels (flare_lm: Model.forward under causal_pallas, the causal kernel;
    qwen2: lm_forward(impl="pallas"), the tensor-core flash kernel), the
    kernel asserted from the profiler's names in that window."""
    import torch

    from repro_torch.models import transformer

    out = {}
    if cfg.family == "flare_lm":
        run = lambda: out.update(logits=model.forward(net, {"tokens": tokens})[0])
        kernel = "causal_tc_kernel"
    else:
        def run():
            with torch.no_grad():
                out.update(logits=transformer.lm_forward(net, tokens, cfg, impl="pallas")[0])
        kernel = "flash_tc_kernel"
    label = f"train {cfg.name} served forward"
    assert_route(breakdown(run, label, top=4), label, (kernel,))
    return out["logits"][..., :cfg.vocab]


def train_mixer(cfg):
    """(module, name) of the plain mixer function the training route runs
    in every layer: causal FLARE's chunked scan (flare_lm) or attn_sdpa's
    chunked route (qwen2 at T > 2,048); each returns [B, H, T, D]."""
    from repro_torch.core import flare_stream
    from repro_torch.models import attention

    return ((flare_stream, "flare_causal") if cfg.family == "flare_lm"
            else (attention, "_chunked_attention"))


def drop_last_tokens(module, name: str, n: int):
    """Replace the mixer ``module.name`` with a wrapper that zeroes its
    output's last ``n`` tokens (a lost chunk); returns the undo function."""
    fn = getattr(module, name)

    def dropped(*args, **kw):
        out = fn(*args, **kw)
        out[..., -n:, :] = 0
        return out

    setattr(module, name, dropped)
    return lambda: setattr(module, name, fn)


def check_train_logits(cfg, model, net, mb) -> tuple:
    """Check 1: the training route's logits of ``mb`` (lm_forward as
    Model.loss runs it, without autograd) against the served forward
    kernels' on the same weights, within LM_TOL's bf16 limit of max |logit|;
    the training route with the last LOST_CHUNK tokens' mixer output
    dropped in every layer must fail that limit. Returns the cross-entropy
    of the training route's and of the served logits (fp64)."""
    import torch

    from repro_torch.models import transformer

    def train_route():
        with torch.no_grad():
            logits = transformer.lm_forward(net, mb["tokens"], cfg,
                                            plan=model.plans.get("train"))[0]
        return logits[..., :cfg.vocab]

    served = served_logits(cfg, model, net, mb["tokens"])
    scale = served.abs().max().item()
    logits = train_route()
    rel = max_err(logits, served) / scale
    losses = lm_cross_entropy(logits, mb["labels"]), lm_cross_entropy(served, mb["labels"])
    del logits
    undo = drop_last_tokens(*train_mixer(cfg), LOST_CHUNK)
    try:
        lost = train_route()
    finally:
        undo()
    rel_lost = max_err(lost, served) / scale
    del served, lost
    torch.cuda.empty_cache()
    ok = math.isfinite(rel) and rel <= LM_TOL["bfloat16"]
    print(f"train {cfg.name} step 0 microbatch 0 logits, training route vs served forward "
          f"kernels: max|served| {scale:.4g}, rel {rel:.3g} (limit {LM_TOL['bfloat16']:g}); the "
          f"last {LOST_CHUNK} tokens' mixer output dropped in every layer: rel {rel_lost:.3g}"
          + ("" if ok else "  FAILED"), flush=True)
    if not ok:
        raise AssertionError(f"train {cfg.name}: the training route's logits differ from the "
                             f"served forward's by rel {rel:.3g}")
    if not rel_lost > LM_TOL["bfloat16"]:
        raise AssertionError(f"train {cfg.name}: the logits limit would pass a lost chunk "
                             f"(rel {rel_lost:.3g})")
    return losses


def mixer_fn(cfg, model):
    """Layer 0's mixer as the training route runs it, on (q, k, v) as the
    model gives them: causal FLARE under the train plan (flare_lm), or
    attn_sdpa's chunked route over the expanded KV heads (qwen2)."""
    from repro_torch.core.policy import run_plan
    from repro_torch.models import attention

    if cfg.family == "flare_lm":
        return lambda q, k, v: run_plan(model.plans["train"], q, k, v)
    groups = cfg.attn.num_heads // cfg.attn.num_kv_heads
    return lambda q, k, v: attention.attn_sdpa(
        q, attention._expand_kv(k, groups), attention._expand_kv(v, groups),
        scale=cfg.attn.head_dim ** -0.5, causal=True, impl="chunked")


def mixer_grads(fn, ops, dy, drop_last: int = 0):
    """(dq, dk, dv) of sum(fn(q, k, v) * dy) by autograd, with the last
    ``drop_last`` tokens left out of the sum."""
    import torch

    leaves = [t.detach().requires_grad_() for t in ops]
    if drop_last:
        dy = dy.clone()
        dy[:, :, -drop_last:] = 0
    (fn(*leaves).to(dy.dtype) * dy).sum().backward()
    return [t.grad for t in leaves]


def check_train_grads(cfg, model, net, tokens) -> None:
    """Layer 0's mixer on the model's own operands at T=LM_TRAIN_T: dq, dk,
    dv through the training route in bf16 and fp32, against fp64 autograd
    through the same function on the same values (attn_sdpa casts its
    scores to fp32, as the JAX package's does, whatever the operands'
    type), within GRAD_TOL of max |g|; the fp64 gradients with the last
    LOST_CHUNK tokens dropped from the loss must fail the bf16 limit."""
    import torch

    from repro_torch.config import replace

    fn = mixer_fn(cfg, model)
    failures, lost_rel = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg_d = replace(cfg, compute_dtype=str(dtype).removeprefix("torch."))
        ops = (lm_operands(net, cfg_d, tokens, dtype) if cfg.family == "flare_lm"
               else attention_operands(net, cfg_d, tokens))
        gen = torch.Generator().manual_seed(SEED + 3)
        dy = torch.randn(tokens.shape[0], cfg.attn.num_heads, tokens.shape[1],
                         cfg.attn.head_dim, generator=gen, dtype=torch.float64).to(tokens.device)
        got = mixer_grads(fn, ops, dy.to(torch.float32))
        wide = [t.to(torch.float64) for t in ops]
        want = mixer_grads(fn, wide, dy)
        lost = mixer_grads(fn, wide, dy, drop_last=LOST_CHUNK)
        key = str(dtype).removeprefix("torch.")
        for name, g, w, x in zip(GRADS, got, want, lost):
            scale = w.abs().max().item()
            rel, rel_lost = max_err(g, w) / scale, max_err(x, w) / scale
            ok = math.isfinite(rel) and rel <= GRAD_TOL[key]
            print(f"  train {cfg.name} layer 0 {name} {key} vs fp64: max|g| {scale:.4g}, rel "
                  f"{rel:.3g} (limit {GRAD_TOL[key]:g}); last {LOST_CHUNK} tokens dropped "
                  f"from the fp64 loss: rel {rel_lost:.3g}" + ("" if ok else "  FAILED"),
                  flush=True)
            if not ok:
                failures.append(f"{name} {key}: rel {rel:.3g}")
            lost_rel[name, key] = rel_lost
        del ops, got, want, lost, wide
        torch.cuda.empty_cache()
    # the check rejects a lost chunk where one of the three gradients moves
    # past the bf16 limit (dq does: each query's own; dk and dv of the last
    # tokens are sums over the few queries after them)
    for key in ("bfloat16", "float32"):
        if not max(lost_rel[name, key] for name in GRADS) > GRAD_TOL["bfloat16"]:
            failures.append(f"{key} operands: the bf16 limit would pass a lost chunk ({lost_rel})")
    if failures:
        raise AssertionError(f"train {cfg.name} layer-0 gradients: " + "; ".join(failures))


def check_remat(cfg, mb) -> None:
    """remat="full" against "none" on REMAT_LAYERS layers at full width, on
    one microbatch: the same loss and gradients (the recomputation runs the
    same kernels on the same inputs; equal expected, REMAT_TOL relative)."""
    import torch

    from repro_torch.config import replace
    from repro_torch.models.api import get_model

    cut = replace(cfg, num_layers=REMAT_LAYERS)
    net, out = None, {}
    for remat in ("full", "none"):
        model = get_model(replace(cut, remat=remat))
        net = model.init(SEED) if net is None else net
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(net, mb)
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad for k, p in net.named_parameters()},
                      torch.cuda.max_memory_allocated() / 2**30)
        for p in net.parameters():
            p.grad = None
    (lf, gf, pf), (ln, gn, pn) = out["full"], out["none"]
    loss_rel = abs(lf - ln) / abs(ln)
    name, grad_rel = max(((k, max_err(gf[k], gn[k]) / max(gn[k].abs().max().item(), 1e-30))
                          for k in gn), key=lambda kv: kv[1])
    print(f"train {cfg.name} remat full vs none ({REMAT_LAYERS} layers, B=1, T={LM_TRAIN_T}): "
          f"loss {lf:.9g} / {ln:.9g} (rel {loss_rel:.3g}), largest gradient difference "
          f"rel {grad_rel:.3g} at {name} (limit {REMAT_TOL:g}); peak {pf:.2f} / {pn:.2f} GiB",
          flush=True)
    if not (loss_rel <= REMAT_TOL and grad_rel <= REMAT_TOL):
        raise AssertionError(f"train {cfg.name}: checkpointing changed the loss (rel "
                             f"{loss_rel:.3g}) or a gradient (rel {grad_rel:.3g} at {name})")
    del net, out
    torch.cuda.empty_cache()


def check_restore(cfg, trainer, step: int) -> None:
    """The final checkpoint read back through CheckpointManager: the JAX LM's
    stacked ``layers/...`` leaves (leading dim num_layers, no per-layer
    path), every parameter equal to the trainer's (compared on the card,
    each leaf moved there and laid out as the port holds it)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.interop import STACKED, jax_leaf

    t0 = time.perf_counter()
    flat = CheckpointManager(trainer.tcfg.checkpoint_dir).restore(step)
    read_s = time.perf_counter() - t0
    stacked = {k: a.shape for k, a in flat.items() if k.startswith(f"{STACKED}/")}
    if not stacked or any(s[0] != cfg.num_layers for s in stacked.values()) or any(
            k.split("/")[1].isdigit() for k in stacked):
        raise AssertionError(f"train {cfg.name}: checkpoint layers not stacked: {stacked}")
    params = trainer.net.state_dict()
    keys = set()
    for name, p in params.items():
        key, i = jax_leaf(name)
        got = torch.from_numpy(flat[key] if i is None else flat[key][i]).to(p.device)
        keys.add(key)
        if not torch.equal(got.T if name.endswith(".weight") else got, p):
            raise AssertionError(f"train {cfg.name}: checkpoint leaf {key} differs from {name}")
    if keys != set(flat):
        raise AssertionError(f"train {cfg.name}: checkpoint leaves {sorted(set(flat) - keys)} "
                             "belong to no parameter")
    print(f"train {cfg.name} checkpoint step {step}: {len(flat)} leaves, {len(stacked)} of them "
          f"stacked layers/... (e.g. {next(iter(stacked))} {tuple(next(iter(stacked.values())))})"
          f"; read and checked in {read_s:.1f} s, every parameter equal "
          f"({time.perf_counter() - t0:.1f} s in all)", flush=True)


def train_lm(arch: str, size: tuple) -> dict:
    """Trainer.fit of get_model(arch) at full width and depth from seed 0 on
    TokenStream batches at T=LM_TRAIN_T (global batch LM_TRAIN_B, microbatches
    of cfg.microbatch), bf16 compute, fp32 parameters, remat "full": the
    checks of the module docstring's phases 11b and 13b, then the fit (a counted
    window: no kernel launch; every layer's mixer runs twice a microbatch,
    forward and recomputation; its last step under the profiler), ms per
    step, tokens/s, model FLOP/s, peak GiB, the breakdown of that step and
    the phase's seconds by part."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer

    parts, clock = {}, [time.perf_counter()]

    def lap(part):   # the seconds since the last lap, kept under ``part``
        now = time.perf_counter()
        parts[part] = round(now - clock[0], 1)
        clock[0] = now

    cfg = get_config(arch)
    model = get_model(cfg, seq_len_hint=LM_TRAIN_T)
    plans = ", ".join(f"{k}: {p.describe()}" for k, p in model.plans.items())
    route = ("causal_stream" if cfg.family == "flare_lm"
             else "attn_sdpa impl=auto: chunked at T > 2,048")
    num_mb = LM_TRAIN_B // cfg.microbatch   # per-device batch / microbatch (one device)
    print(f"train {cfg.name}: plans {{{plans}}} ({route}); T={LM_TRAIN_T}, global batch "
          f"{LM_TRAIN_B} (train_4k's 256 cut), {num_mb} microbatches of {cfg.microbatch}, "
          f"{LM_TRAIN_STEPS} steps; {cfg.compute_dtype} compute, {cfg.param_dtype} parameters, "
          f"remat {cfg.remat}", flush=True)
    if cfg.family == "flare_lm" and model.plans["train"].describe() != (
            f"causal_stream(chunk_size={cfg.attn.flare_chunk};mode=factored)"):
        raise AssertionError(f"flare_lm train plan {model.plans['train'].describe()}")
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: remat {cfg.remat}, compute {cfg.compute_dtype}")
    stream = TokenStream(cfg.vocab, LM_TRAIN_T, seed=SEED)
    feed_ms = []

    def batch_fn(step):   # the JAX launcher's LM batches, their host time kept
        t0 = time.perf_counter()
        batch = stream.global_batch(step, LM_TRAIN_B, 1)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        return batch

    first = []

    def loss(net, mb):   # the train route's loss, its first microbatch kept
        value = model.loss(net, mb)
        if not first:
            first.append(value.item())
        return value

    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = TrainConfig(steps=LM_TRAIN_STEPS, seed=SEED, checkpoint_dir=ckdir,
                           checkpoint_every=10 * LM_TRAIN_STEPS, log_every=1)
        trainer = Trainer(dataclasses.replace(model, loss=loss,
                                              init=lambda seed: card_init(model, seed)),
                          tcfg, num_microbatches=num_mb)
        n_params = sum(p.numel() for p in trainer.net.parameters())
        lap("init")
        print(f"init {cfg.name} for training: {cfg.num_layers} layers, {n_params} parameters "
              f"drawn on the card and AdamW's moments allocated in {parts['init']} s", flush=True)
        if (cfg.num_layers, n_params) != size:
            raise AssertionError(f"{cfg.name} is not at full size: {cfg.num_layers} layers, "
                                 f"{n_params} parameters")
        device = next(trainer.net.parameters()).device
        mb0 = {k: torch.from_numpy(v[:cfg.microbatch]).to(device)
               for k, v in batch_fn(0).items()}
        route_ce, served_ce = check_train_logits(cfg, model, trainer.net, mb0)
        lap("check 1 (logits)")
        check_train_grads(cfg, model, trainer.net, mb0["tokens"])
        lap("check 2 (gradients)")

        step_fn, trace = trainer._train_step, {}

        def last_step_traced(*args):   # the fit's last step runs under the profiler
            if trainer.step < LM_TRAIN_STEPS - 1:
                return step_fn(*args)
            out, trace["profile"] = traced(lambda: step_fn(*args))
            return out

        trainer._train_step = last_step_traced
        module, name = train_mixer(cfg)
        calls, undo = count_calls(module, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        try:
            history = trainer.fit(batch_fn)
        finally:
            undo()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms_steps = [1e3 * h["time"] for h in history]
        lap("fit")
        ckpt_s = parts["fit's final checkpoint"] = round(parts["fit"] - sum(ms_steps) / 1e3, 1)
        # the median of steps 2-4: the profiled step 4 moves it at most to
        # the slower of steps 2 and 3
        ms = sorted(ms_steps[1:])[len(ms_steps[1:]) // 2]
        tokens = LM_TRAIN_B * LM_TRAIN_T
        print(f"train {cfg.name} losses {[h['loss'] for h in history]}, grad_norm "
              f"{[h['grad_norm'] for h in history]}, lr {[h['lr'] for h in history]}", flush=True)
        print(f"train {cfg.name} ms/step {[round(t, 3) for t in ms_steps]} (host clock, the "
              f"TokenStream feed included: {[round(t, 1) for t in feed_ms[-LM_TRAIN_STEPS:]]} ms; "
              f"step {LM_TRAIN_STEPS} under the profiler); the fit's final blocking checkpoint "
              f"{ckpt_s} s", flush=True)
        print(f"train {cfg.name} T={LM_TRAIN_T} B={LM_TRAIN_B}: {ms:.3f} ms/step (median of steps "
              f"2-{LM_TRAIN_STEPS}), {tokens / ms * 1e3:.1f} tokens/s, model FLOP/s "
              f"{6 * n_params * tokens / ms * 1e3 / 1e12:.1f} T = "
              f"{100 * 6 * n_params * tokens / (ms / 1e3) / PEAK_BF16:.2f}% of {PEAK_BF16 / 1e12:.0f} "
              f"TFLOP/s (6 x params x tokens; the recomputation left out), peak {peak:.2f} GiB; "
              f"{name} calls {calls['n']}; kernel launches {launched({'launches': counts})}",
              flush=True)
        print(f"train {cfg.name} step 0 microbatch 0 loss: the fit's {first[0]:.6f}; the "
              f"cross-entropy of check 1's training-route logits {route_ce:.6f}, of the served "
              f"logits {served_ce:.6f}", flush=True)
        want_calls = LM_TRAIN_STEPS * num_mb * cfg.num_layers * 2
        if any(counts.values()) or calls["n"] != want_calls:
            raise AssertionError(f"train {cfg.name}: launches {counts}, {name} calls "
                                 f"{calls['n']} (expected {want_calls})")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
            raise AssertionError(f"train {cfg.name}: a loss or grad_norm is not finite")
        report(*trace["profile"], f"train {cfg.name} step {LM_TRAIN_STEPS} of the fit", top=12)
        lap("breakdown's processing")
        check_restore(cfg, trainer, LM_TRAIN_STEPS)
        lap("check 4 (checkpoint read)")
    del trainer
    torch.cuda.empty_cache()
    check_remat(cfg, mb0)
    lap("check 3 (remat)")
    print(f"train {cfg.name} seconds by part: {parts}", flush=True)
    return {"ms": ms, "peak": peak}


# --------------------------------------------------------------------------
# Serving qwen2-1.5b from the paged pool: the paged-attention kernel, the
# paged FLARE backend and the continuous-batching engine
# --------------------------------------------------------------------------


def paged_operands(g, d, page_dtype, q2, device, gen, *, qdt=None):
    """Random paged-attention operands: q [B, H, G, D] and pages [NB, block,
    H, D] of ``page_dtype`` (int8 / fp8 quantized with per-row scales), a
    shuffled page table whose unmapped entries point at a trash row of NaN,
    and lengths 0 (lane 0), a partial page (lane 1) and the whole table.
    Returns ((q, k, v, page_table, lengths), the optional operands, trash id)."""
    import torch

    from repro_torch.serve.pool.quant import get_quant, quantize

    qdt = qdt or torch.float32
    b, h, block, pages = 3, 2, 16, 24
    nb = b * pages + 1
    q = torch.randn(b, h, g, d, generator=gen) * d ** -0.5
    k = torch.randn(nb, block, h, d, generator=gen)
    v = torch.randn(nb, block, h, d, generator=gen)
    lengths = torch.tensor([0, block * (pages // 2) + block // 2, block * pages],
                           dtype=torch.int32)
    pt = torch.randperm(nb - 1, generator=gen)[: b * pages].reshape(b, pages).int()
    for i in range(b):
        pt[i, -(-int(lengths[i]) // block):] = nb - 1
    kw = {}
    if page_dtype in ("int8", "fp8"):
        spec = get_quant(page_dtype)
        (k, ks), (v, vs) = quantize(spec, k), quantize(spec, v)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(getattr(torch, page_dtype)), v.to(getattr(torch, page_dtype))
    if q2:
        kw["q2"] = (torch.randn(b, h, g, 16, generator=gen) * 0.25).to(qdt)
        k2 = torch.randn(nb, block, h, 16, generator=gen)
        if page_dtype in ("int8", "fp8"):
            k2, kw["k2_scale"] = quantize(get_quant(page_dtype), k2)
        kw["k2_pages"] = k2.to(k.dtype)
    k[nb - 1] = v[nb - 1] = (torch.nan if k.is_floating_point() else 127)
    ops = (q.to(qdt), k, v, pt, lengths)
    return tuple(t.to(device) for t in ops), {key: t.to(device) for key, t in kw.items()}, nb - 1


def drop_page(pt, lengths, block: int, filler: int):
    """The page table and lengths with page 0 of the longest lane left out:
    its later pages shift left (``filler`` fills the end) and its length
    loses that page's tokens. The plain version on these is what a kernel
    that skipped one page would give."""
    lane = int(lengths.argmax())
    pt, lengths = pt.clone(), lengths.clone()
    pt[lane, :-1] = pt[lane, 1:].clone()
    pt[lane, -1] = filler
    lengths[lane] -= min(block, int(lengths[lane]))
    return pt, lengths


def wide_kw(kw: dict) -> dict:
    return {key: t.double() if key == "q2" else t for key, t in kw.items()}


def check_paged_small(checks: Checks, device) -> None:
    """The paged kernel against its plain version on random operands: fp32
    queries over every page dtype, with and without q2 k2, against the plain
    version in fp64 (fp32 limits); bf16 queries over bf16 pages (the plain
    path, weights rounded to bf16) against the plain version on the same
    inputs (bf16 limits). Each must reject the plain version that left one
    page of the longest lane out, and the length-0 lane must be exact zeros."""
    import torch

    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref as ref

    gen = torch.Generator().manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    print("kernels paged on random operands (B=3 H=2 block=16 P=24; lanes of 0, 200 and 384 "
          "tokens; unmapped pages at a NaN trash row; scale 0.7):", flush=True)
    for g, d in PAGED_SMALL:
        for page_dtype in PAGE_DTYPES:
            for q2 in (False, True):
                ops, kw, trash = paged_operands(g, d, page_dtype, q2, device, gen)
                q, k, v, pt, lengths = ops
                got = paged_attention(*ops, scale=PAGED_SCALE, out_dtype=f32, **kw)
                plain32 = ref(*ops, scale=PAGED_SCALE, out_dtype=f32, **kw)
                q64, wkw = q.double(), wide_kw(kw)
                want = ref(q64, k, v, pt, lengths, scale=PAGED_SCALE, out_dtype=torch.float64,
                           **wkw)
                drop = ref(q64, k, v, *drop_page(pt, lengths, 16, trash), scale=PAGED_SCALE,
                           out_dtype=torch.float64, **wkw)
                what = f"G={g} D={d} {page_dtype}{' +q2' if q2 else ''}"
                checks.hold("paged_attention", what, got, want, f32, atol=ATOL["float32"],
                            record=True, dropped={"page": drop}, fp32_plain=plain32)
                if got[0].any():
                    checks.failures.append(f"paged_attention {what}: the length-0 lane is not 0")
        ops, _, trash = paged_operands(g, d, "bfloat16", False, device, gen, qdt=bf16)
        drop = ref(*ops[:3], *drop_page(ops[3], ops[4], 16, trash), scale=PAGED_SCALE)
        checks.hold("paged_attention", f"G={g} D={d} bf16 q", paged_attention(
            *ops, scale=PAGED_SCALE), ref(*ops, scale=PAGED_SCALE), bf16, atol=ATOL["bfloat16"],
            dropped={"page": drop})
    checks.raise_failures("paged kernel on random operands")


def paged_by_head(q, k, v, pt, lengths, *, scale=1.0, out_dtype=None, **kw):
    """The plain paged version a KV head at a time (its [B, 1, G, T] scores
    must fit the card), concatenated over heads."""
    import torch

    from repro_torch.kernels.ref import paged_attention_ref

    outs = []
    for i in range(q.shape[1]):
        head = {key: t[:, i:i + 1] if key == "q2" else t[:, :, i:i + 1] for key, t in kw.items()}
        outs.append(paged_attention_ref(q[:, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1], pt,
                                        lengths, scale=scale, out_dtype=out_dtype, **head))
    return torch.cat(outs, dim=1)


def check_paged_main(checks: Checks, label: str, op: dict) -> dict:
    """The paged kernel on a main path's own operands (``op``: q, pages, page
    table, lengths and the call's keywords), against the plain version in
    fp64 a head at a time, with the kernel's output in fp32 (the arithmetic
    at fp32 limits; the output the model takes, in its own dtype, is printed
    beside), rejecting one left-out page. Then times: the kernel as the model
    calls it, its bound, the plain version, and one SDPA over the dense view
    gathered beforehand (not timed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import _gather_rows, paged_attention_ref

    q, k, v, pt, lengths = (op[key] for key in ("q", "k_pages", "v_pages", "page_table",
                                                "lengths"))
    kw = {key: op.get(key) for key in ("scale", "k_scale", "v_scale")}
    kw = {key: t for key, t in kw.items() if t is not None}
    b, h, g, d = q.shape
    block = k.shape[1]
    print(f"kernels paged {label} (the main path's operands: q {tuple(q.shape)} {q.dtype}, "
          f"pages {tuple(k.shape)} {k.dtype}, lengths {lengths.tolist()[:8]}, "
          f"scale {kw.get('scale', 1.0):.5g}; held against the plain version in fp64):",
          flush=True)
    got = paged_attention(q, k, v, pt, lengths, out_dtype=torch.float32, **kw)
    plain32 = paged_by_head(q, k, v, pt, lengths, out_dtype=torch.float32, **kw)
    want = paged_by_head(q.double(), k, v, pt, lengths, out_dtype=torch.float64, **kw)
    drop = paged_by_head(q.double(), k, v, *drop_page(pt, lengths, block, int(pt[0, 0])),
                         out_dtype=torch.float64, **kw)
    checks.hold("paged_attention", f"{label} fp32 out", got, want, torch.float32,
                atol=ATOL["float32"], record=True, dropped={"page": drop}, fp32_plain=plain32)
    out_dtype = op.get("out_dtype") or torch.float32
    model_out = paged_attention(q, k, v, pt, lengths, out_dtype=out_dtype, **kw)
    rel = max_err(model_out, want) / want.abs().max().item()
    print(f"  as the model calls it ({out_dtype} out): rel {rel:.3g}", flush=True)
    checks.raise_failures(f"paged kernel on {label}")
    del got, plain32, want, drop
    # bound: each valid page (and its scales) once, q and the output once;
    # two products of 2*G*D FLOP a valid token per head on the CUDA cores
    pages = ((lengths.long() + block - 1) // block).clamp(max=pt.shape[1]).sum().item()
    row = h * d * k.element_size() + (h * 4 if "k_scale" in kw else 0)
    nbytes = 2 * pages * block * row + q.numel() * q.element_size() \
        + q.numel() * model_out.element_size()
    flops = 4 * g * d * h * lengths.long().sum().item()
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BW * 1e3
    kd, vd = _gather_rows(k, pt), _gather_rows(v, pt)    # the dense view, in the pages' dtype
    mask = (torch.arange(kd.shape[2], device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    qd = q.to(kd.dtype)
    kernel = lambda: paged_attention(q, k, v, pt, lengths, out_dtype=out_dtype, **kw)
    plain = lambda: paged_attention_ref(q, k, v, pt, lengths, out_dtype=out_dtype, **kw)
    library = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                     scale=kw.get("scale", 1.0))
    # device times, each call replayed from a CUDA graph (a decode read's
    # host cost is about its device time); the eager calls' pace beside
    stats = dict(ms=graph_ms(kernel, reps=50), plain_ms=graph_ms(plain, reps=10),
                 library_ms=graph_ms(library, reps=50), bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    eager = {name: cuda_ms(fn, reps=20) for name, fn in
             (("kernel", kernel), ("plain", plain), ("library", library))}
    print(f"time paged_attention {label}: {stats} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} "
          f"GFLOP); eager calls back to back, ms a call: {eager}", flush=True)
    return stats


def encode_operands(net, x) -> dict:
    """Block 0's FLARE encode as the ``paged`` backend gives it to the paged
    kernel: q broadcast to [B, H, M, D], k and v packed into pages of 16
    with an identity page table, every token valid."""
    import torch

    from repro_torch.backends.paged import pack_pages

    q, k, v = mixer_operands(net, x)
    b, h, n, d = k.shape
    kp, pt = pack_pages(k, 16)
    vp, _ = pack_pages(v, 16)
    return {"q": q[None].expand(b, *q.shape).contiguous(), "k_pages": kp, "v_pages": vp,
            "page_table": pt, "lengths": torch.full((b,), n, dtype=torch.int32, device=k.device),
            "scale": 1.0}


def path_pde_paged(cfg, net, batch, checks: Checks) -> dict:
    """``get_model(flare_pde)`` under policy ``paged`` (the encode through the
    paged kernel) on one pde_40k example: launch counts zeroed before and
    read after (8, one a block), held against the plain ``sdpa`` path at
    1e-3 abs and rel (the backend's plain decode materialises [B, H, M, N]
    fp32 scores: 2.6 GB at B=1)."""
    import torch

    from repro_torch.core.policy import MixerPolicy
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model

    model = get_model(cfg, policy=MixerPolicy(backends=("paged",)))
    plan = model.plans["infer"].describe()
    one = {"x": batch["x"][:1], "y": batch["y"][:1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward(net, one)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    rel_l2 = check_output("paged pde_40k", out, one)
    print(f"path flare_pde paged (plan {plan}) pde_40k B=1 N={one['x'].shape[1]}: {ms:.3f} ms "
          f"(one forward), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, rel-L2 vs "
          f"target {rel_l2:.4f}; launches {counts}", flush=True)
    if plan != "paged(block=16)" or counts["paged_attention"] != cfg.num_layers or any(
            n for name, n in counts.items() if name != "paged_attention"):
        raise AssertionError(f"paged path: plan {plan}, launches {counts}")
    want = get_model(cfg, policy=MixerPolicy(backends=("sdpa",))).forward(net, one)
    err, scale = max_err(out, want), want.abs().max().item()
    print(f"path paged vs sdpa B=1 N={one['x'].shape[1]} over {cfg.num_layers} blocks: "
          f"max|plain| {scale:.4g}, max abs err {err:.3g} (atol {PATH_TOL}), rel "
          f"{err / scale:.3g} (rtol {PATH_TOL})", flush=True)
    if not (err <= PATH_TOL and err / scale <= PATH_TOL):
        raise AssertionError(f"paged path differs from the plain path by {err}")
    return counts


def serve_requests(vocab: int, n: int, new_tokens, *, longest_first: bool, lens=PROMPT_LENS):
    """Seeded prompts of ``lens`` tokens (256-2,048 by default; uniform ids)
    and their max new tokens."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(lens[0], lens[1] + 1, n)
    if longest_first:
        lens = np.sort(lens)[::-1]
    news = rng.integers(new_tokens[0], new_tokens[1] + 1, n)
    return [(rng.integers(0, vocab, int(m)).astype(np.int32), int(k)) for m, k in zip(lens, news)]


def serve_run(model, net, reqs, label: str, *, profile: bool = False, base=SERVE,
              graph: bool = True, paged_per_step=None, **kw) -> dict:
    """One engine (``base`` settings, updated by ``kw``) over the requests:
    on the graph route (``graph``) ``warmup`` first (every prefill bucket of
    the requests, then the decode step captured as one CUDA graph: one
    build, and none while serving), else the eager step (no build); launch
    counts zeroed just before the requests and read just after (a replay
    adds the launches its capture recorded); the first decode step's logits
    and the slots it decoded; one decode step profiled once the queue has
    drained (its time kept out of the step mean and of tokens/s, which is
    over the wall of every prefill and decode step). The kernel route must
    launch ``paged_per_step`` paged reads a decode step (default: one a
    layer)."""
    import gc

    import torch

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(model, net, **{**base, **kw}, cuda_graph=graph)
    name = model.cfg.name
    route = "graph" if graph else "eager"
    warm_s = 0.0
    if graph:
        engine.warmup(max_prompt_len=max(len(p) for p, _ in reqs))
        warm_s = engine.stats["warmup_s"]
    builds = engine.stats["decode_compiles"]
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    reset_launch_counts()
    t0 = time.perf_counter()
    first, prof, prof_s, prof_steps, prof_wall = None, None, 0.0, 0, 0.0
    while True:
        if (profile and prof is None and not engine.sched.waiting
                and len(engine.sched.running) > 1):
            s0, n0, w0 = engine.stats["decode_s"], engine.stats["decode_steps"], time.perf_counter()
            prof = breakdown(engine.step, f"serve {name} {label} decode step "
                             f"({len(engine.sched.running)} slots busy)") or {}
            prof_s, prof_steps = engine.stats["decode_s"] - s0, engine.stats["decode_steps"] - n0
            prof_wall = time.perf_counter() - w0
            more = engine.sched.has_work()
        else:
            more = engine.step()
        if first is None and engine.last_logits is not None:
            slots = sorted({slot for _, slot in engine.sched.admission_log})
            first = (engine.last_logits.float().clone(), slots)
        if not more:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - prof_wall    # the profiled step (and profiler start) left out
    counts = launch_counts()
    st = engine.stats
    steps = st["decode_steps"] - prof_steps
    out = {
        "label": label, "backend": st["decode_backend"], "counts": counts, "graph": graph,
        "tokens": [r.tokens for r in sorted(engine.sched.finished, key=lambda r: r.rid)],
        "first_logits": first[0], "first_slots": first[1],
        "prefill_ms": 1e3 * st["prefill_s"] / st["requests"],
        "step_ms": 1e3 * (st["decode_s"] - prof_s) / steps, "steps": st["decode_steps"],
        "tok_s": st["tokens_generated"] / wall, "wall_s": wall, "warmup_s": warm_s,
        "per_step": counts["paged_attention"] / st["decode_steps"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "stats": st, "prof": prof,
    }
    pool = st.get("pool")
    print(f"serve {name} {label} ({route}): decode backend {st['decode_backend']}; "
          f"{st['requests']} requests, {st['tokens_generated']} tokens in {wall:.2f} s "
          f"({out['tok_s']:.1f} tok/s); prefill {out['prefill_ms']:.2f} ms/request; decode "
          f"{out['step_ms']:.3f} ms/step over {steps} steps; paged launches "
          f"{counts['paged_attention']} ({out['per_step']:g} a step); decode builds "
          f"{builds} after warmup ({warm_s:.2f} s), {st['decode_compiles']} after serving; "
          f"sample_host_syncs {st['sample_host_syncs']}; admitted_peak "
          f"{st['admitted_peak']}/{base['slots']}, page_waits {st['page_waits']}; latency "
          f"p50/p99 {st['latency_p50_s'] * 1e3:.1f}/{st['latency_p99_s'] * 1e3:.1f} ms; peak "
          f"{out['peak_gib']:.2f} GiB; {st['cache']}"
          + (f"; pool {pool}" if pool else ""), flush=True)
    if prof:
        dev = sum(prof[0].values())
        kern = sum(ms for key, ms in prof[0].items() if "paged_" in key)
        out["busy"], out["kernel_share"] = dev / prof[1], kern / dev
        print(f"  decode step ({route}): device busy {100 * out['busy']:.1f}% of {prof[1]:.3f} ms "
              f"wall, paged kernel {kern:.3f} ms = {100 * out['kernel_share']:.1f}% of device "
              "time", flush=True)
    if st["sample_host_syncs"] or st["finished"] != len(reqs):
        raise AssertionError(f"{label}: host syncs {st['sample_host_syncs']}, finished "
                             f"{st['finished']} of {len(reqs)}")
    if (builds, st["decode_compiles"]) != ((1, 1) if graph else (0, 0)) or (
            graph and engine.device.type == "cuda" and engine._graph is None):
        raise AssertionError(f"{label} ({route}): decode builds {builds} after warmup, "
                             f"{st['decode_compiles']} after serving, graph captured "
                             f"{engine._graph is not None}")
    if engine.paged:
        engine.check_invariants()
        if pool["blocks_free"] != pool["blocks_total"] or pool["blocks_reserved"]:
            raise AssertionError(f"{label}: the pool kept blocks: {pool}")
    want = ((paged_per_step or model.cfg.num_layers) if kw.get("decode_backend") == "paged"
            else 0)
    if counts["paged_attention"] != want * st["decode_steps"] or any(
            n for name, n in counts.items() if name != "paged_attention"):
        raise AssertionError(f"{label}: launches {counts} over {st['decode_steps']} steps, "
                             f"expected {want} paged a step")
    del engine
    gc.collect()   # an engine's scheduler holds it in a cycle, and it holds its graph's pool
    torch.cuda.empty_cache()
    return out


def graph_held(label: str, graph: dict, eager: dict, dtype: str) -> None:
    """A graph-route run against its eager oracle on the same prompts (the
    oracle may decode fewer tokens a request): the first decode step's
    logits on the slots both decoded within ``ROUTE_TOL[dtype]`` of max
    |logit|; the greedy tokens compared over the oracle's lengths, equal in
    fp32, the first divergence printed in bf16; decode ms a step, busy
    shares and peak GiB printed side by side."""
    slots = sorted(set(graph["first_slots"]) & set(eager["first_slots"]))
    held(f"serve {label} graph vs eager first-step logits ({len(slots)} slots)",
         graph["first_logits"][slots], eager["first_logits"][slots], ROUTE_TOL[dtype])
    div = first_divergence([g[:len(e)] for g, e in zip(graph["tokens"], eager["tokens"])],
                           eager["tokens"])
    busy = lambda run: f"{100 * run['busy']:.1f}%" if "busy" in run else "not measured"
    print(f"serve {label} graph vs eager: greedy tokens over the eager run's "
          f"{sum(map(len, eager['tokens']))} "
          + ("all equal" if div is None else f"first differ at request {div[0]}, token {div[1]}")
          + f"; decode {graph['step_ms']:.3f} vs {eager['step_ms']:.3f} ms/step "
          f"({eager['step_ms'] / graph['step_ms']:.2f}x); busy {busy(graph)} vs {busy(eager)}; "
          f"peak {graph['peak_gib']:.2f} vs {eager['peak_gib']:.2f} GiB; warmup "
          f"{graph['warmup_s']:.2f} s", flush=True)
    if dtype == "float32" and div is not None:
        raise AssertionError(f"{label}: fp32 greedy tokens of the graph route differ from the "
                             f"eager step's at request {div[0]}, token {div[1]}")


def first_divergence(a: list, b: list):
    """(request, position) of the first token where two runs differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, w) in enumerate(zip(x, y)):
            if u != w:
                return i, j
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None


def first_step_held(label: str, run: dict, ref: dict, tol: float) -> None:
    """The first decode step's logits of two runs on the slots both decoded."""
    slots = sorted(set(run["first_slots"]) & set(ref["first_slots"]))
    held(f"serve {label} first-step logits vs dense pool ({len(slots)} slots)",
         run["first_logits"][slots], ref["first_logits"][slots], tol)


def init_dense_lm(arch: str, size: tuple, *, on_card: bool = False):
    """``get_model(arch)`` at full width and depth from seed 0, drawn on the
    CPU or, ``on_card``, on the card: (cfg, model, net), the seconds the draw
    takes printed; raises unless (layers, parameters) is ``size``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    model = get_model(cfg)
    t0 = time.perf_counter()
    net = card_init(model) if on_card else model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.attn.num_heads} heads / {cfg.attn.num_kv_heads} KV heads x {cfg.attn.head_dim}, "
          f"{n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32) drawn on the "
          f"{'card' if on_card else 'CPU'} in {time.perf_counter() - t0:.1f} s", flush=True)
    if (cfg.num_layers, n_params) != size:
        raise AssertionError(f"{cfg.name} is not at full size: {cfg.num_layers} layers, "
                             f"{n_params} parameters")
    return cfg, model, net


def capture_decode_read(model, net, reqs, base: dict) -> dict:
    """Layer 0's paged-attention operands after the first decode step of an
    engine (``base`` settings, the kernel route) over ``reqs``: captured from
    the wrapper's first call in an uncounted engine step."""
    import torch

    from repro_torch.kernels import paged_attention as paged_module
    from repro_torch.serve.engine import ServeEngine

    captured, kernel = {}, paged_module.paged_attention

    def capture(q, k_pages, v_pages, page_table, lengths, **kw):
        if not captured:
            kc = k_pages.clone()   # MLA's read passes one tensor as K and V: kept one
            captured.update(q=q.clone(), k_pages=kc,
                            v_pages=kc if v_pages is k_pages else v_pages.clone(),
                            page_table=page_table.clone(), lengths=lengths.clone(), **kw)
        return kernel(q, k_pages, v_pages, page_table, lengths, **kw)

    # while it captures, the wrapper counts its launch through its module's
    # name, which points here: on capture's counters, outside every count read
    capture.launches = 0
    capture.launches_by_route = dict.fromkeys(kernel.launches_by_route, 0)
    engine = ServeEngine(model, net, **base, decode_backend="paged", cuda_graph=False)
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    paged_module.paged_attention = capture
    try:
        engine.step()
    finally:
        paged_module.paged_attention = kernel
    del engine
    torch.cuda.empty_cache()
    return captured


def qwen2_phases(checks: Checks, cfg, model, net) -> dict:
    """Qwen2-1.5B at full width and depth: the paged kernel on the pool's
    own operands, then serving through the dense pool, the paged pool's
    gather route and its kernel route in bf16 (the counted window is the
    kernel route's), all by graph replay, the kernel route held against its
    eager oracle; the three routes in fp32 compute, graph and eager (greedy
    tokens equal across routes and between the two); the int8 and fp8
    pools, each against an eager oracle of two tokens a request."""
    import torch

    from repro_torch.config import replace
    from repro_torch.models.api import get_model

    t_phase = time.perf_counter()
    reqs = serve_requests(cfg.vocab, SERVE_REQUESTS, NEW_TOKENS, longest_first=True)
    print(f"requests: {len(reqs)} prompts of {[len(p) for p, _ in reqs]} tokens, "
          f"{[m for _, m in reqs]} new tokens each; engine {SERVE}", flush=True)

    # the kernel on layer 0's operands after the first decode step
    captured = capture_decode_read(model, net, reqs, SERVE)
    stats = check_paged_main(checks, "qwen2-1.5b decode read layer 0", captured)
    del captured

    runs = {name: serve_run(model, net, reqs, f"bf16 {name}", profile=True, **kw)
            for name, kw in ROUTES.items()}
    for name in ("gather", "paged"):
        div = first_divergence(runs[name]["tokens"], runs["dense"]["tokens"])
        print(f"serve bf16 {name} vs dense: greedy tokens "
              + ("all equal" if div is None else f"first differ at request {div[0]}, token "
                 f"{div[1]}"), flush=True)
        first_step_held(f"bf16 {name}", runs[name], runs["dense"], ROUTE_TOL["bfloat16"])
    if runs["paged"]["stats"]["page_waits"] == 0:
        raise AssertionError("admission never waited for pages: the pool does not bind")
    eager = serve_run(model, net, [(p, EAGER_NEW) for p, _ in reqs], "bf16 paged",
                      profile=True, graph=False, **ROUTES["paged"])
    graph_held("qwen2-1.5b bf16 paged", runs["paged"], eager, "bfloat16")
    del eager

    model32 = get_model(replace(cfg, compute_dtype="float32"))
    reqs32 = serve_requests(cfg.vocab, SERVE32_REQUESTS, (SERVE32_NEW, SERVE32_NEW),
                            longest_first=False)
    runs32 = {name: serve_run(model32, net, reqs32, f"fp32 {name}", **kw)
              for name, kw in ROUTES.items()}
    for name in ("gather", "paged"):
        first_step_held(f"fp32 {name}", runs32[name], runs32["dense"], ROUTE_TOL["float32"])
        div = first_divergence(runs32[name]["tokens"], runs32["dense"]["tokens"])
        if div is not None:
            raise AssertionError(f"fp32 {name}: greedy tokens differ from the dense pool's at "
                                 f"request {div[0]}, token {div[1]}")
    for name, kw in ROUTES.items():
        graph_held(f"qwen2-1.5b fp32 {name}", runs32[name],
                   serve_run(model32, net, reqs32, f"fp32 {name}", graph=False, **kw),
                   "float32")
    print(f"serve fp32: the greedy tokens of all {SERVE32_REQUESTS} x {SERVE32_NEW} positions "
          "are equal across the dense, gather and kernel routes, graph and eager", flush=True)
    del runs32, model32

    # the quantized pools, held on the first decode step's logits against
    # the dense pool's, and against an eager oracle of two tokens a request
    short = [(prompt, 2) for prompt, _ in reqs]
    for quant in ("int8", "fp8"):
        run = serve_run(model, net, reqs, f"bf16 paged kv_quant={quant}", kv_quant=quant,
                        decode_backend="paged")
        slots = sorted(set(run["first_slots"]) & set(runs["dense"]["first_slots"]))
        got, want = run["first_logits"][slots], runs["dense"]["first_logits"][slots]
        excess = ((got - want).abs() - QUANT_ENVELOPE["atol"]
                  - QUANT_ENVELOPE["rtol"] * want.abs()).max().item()
        print(f"serve kv_quant={quant} first-step logits vs dense pool: max|ref| "
              f"{want.abs().max().item():.4g}, max abs diff {max_err(got, want):.4g}, worst "
              f"|diff| - (atol + rtol |ref|) {excess:.4g} (envelope {QUANT_ENVELOPE})",
              flush=True)
        if not excess <= 0:
            raise AssertionError(f"kv_quant={quant}: first-step logits outside the envelope")
        graph_held(f"qwen2-1.5b bf16 paged kv_quant={quant}", run,
                   serve_run(model, net, short, f"bf16 paged kv_quant={quant}", graph=False,
                             kv_quant=quant, decode_backend="paged"), "bfloat16")
    stats["launches"] = runs["paged"]["counts"]["paged_attention"]
    stats["serve"] = {name: {key: run[key] for key in ("step_ms", "tok_s", "prefill_ms")}
                      for name, run in runs.items()}
    del runs
    torch.cuda.empty_cache()
    print(f"serve qwen2-1.5b phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return stats


def launcher_run() -> None:
    """The serving launcher at full size, as scripts/ci.sh runs the JAX one:
    qwen2-1.5b through the paged kernel with ``--warmup
    --max-decode-compiles 0`` must exit 0 with no build while serving and
    ``host syncs/step: 0.0``."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2_1_5b",
           "--requests", "6", "--max-new", "12", "--capacity", "128", "--slots", "4",
           "--pool-tokens", "512", "--block-size", "16", "--decode-backend", "paged",
           "--warmup", "--max-decode-compiles", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("warmup:", "decode compiles:", "decode backend:", "6 requests"))]
    print(f"launch serve qwen2_1_5b --warmup --max-decode-compiles 0: exit {out.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines), flush=True)
    if out.returncode != 0 or "host syncs/step: 0.0" not in out.stdout or \
            "0 while serving" not in out.stdout:
        raise AssertionError(f"the launcher failed its bound: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


# --------------------------------------------------------------------------
# The prefix cache: qwen2-1.5b served with a shared prompt template
# --------------------------------------------------------------------------


def prefix_workload(vocab: int, template_len: int, n: int):
    """(template, prompts): one seeded ``template_len``-token template;
    request 0 is the exact template, request i > 0 the template and tail
    ``i % PREFIX_VARIANTS`` (seeded tails of ``PREFIX_TAILS`` tokens)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 22)
    template = rng.integers(0, vocab, template_len).astype(np.int32)
    lens = rng.integers(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1, PREFIX_VARIANTS)
    tails = [rng.integers(0, vocab, int(m)).astype(np.int32) for m in lens]
    return template, [template.copy()] + [np.concatenate([template, tails[i % len(tails)]])
                                          for i in range(1, n)]


def record_prefills(engine, profile: bool = False) -> dict:
    """Wrap the engine's prefills (full and suffix) to keep, by request id,
    the logits its first token is sampled from and whether it was a hit,
    and each prefill's ms a request (host clock around the call and a
    synchronize, where the engine synchronizes anyway, to sample).
    ``profile``: the first prefill of each kind runs under the profiler
    (its device busy share and kernels printed)."""
    import torch

    rec = {"logits": {}, "hit": {}, "ms": {"cold": [], "hit": []}}

    def wrap(fn, kind):
        def run(net, batch, pool, slots, *rest):
            t0 = time.perf_counter()
            if profile and not rec["ms"][kind]:
                (logits, pool), prof = traced(lambda: fn(net, batch, pool, slots, *rest))
                report(*prof, f"serve prefix {kind} prefill (bucket {batch['tokens'].shape[1]})")
            else:
                logits, pool = fn(net, batch, pool, slots, *rest)
            torch.cuda.synchronize()
            rec["ms"][kind].append((time.perf_counter() - t0) * 1e3 / len(slots))
            for i, slot in enumerate(slots.tolist()):
                rid = engine.sched.running[slot].rid
                rec["logits"][rid], rec["hit"][rid] = logits[i].float().clone(), kind == "hit"
            return logits, pool
        return run

    engine._prefill_into = wrap(engine._prefill_into, "cold")
    if engine._prefix_enabled:
        engine._prefill_suffix = wrap(engine._prefill_suffix, "hit")
    return rec


def scope_counts(fn, names) -> dict:
    """How many times each ``obs.scope`` name in ``names`` opens in one call
    of ``fn``, from a torch.profiler trace of host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    return counts


def prefix_run(model, net, template, prompts, label: str, *, cache: bool, new: int,
               corrupt=None, expire: bool = False, profile: bool = False,
               profile_prefills: bool = False, graph: bool = True, **kw) -> dict:
    """One engine (``SERVE``, the paged kernel route, ``kw`` on top) over the
    prompts, the template pinned first where ``cache``: on the graph route
    (``graph``) ``warmup`` at the smallest bucket first (its point here is
    the decode step's capture: one build, none while serving), else the
    eager step; launch counts zeroed just before and read just after; the
    first decode step's logits and slots; ``check_invariants`` (every reference
    held by a lease, a pin or a queued request) after every step; the peaks
    of resident requests and shared pages. Then the pins are released, and
    every block must be free or cached-free with no reference left.
    ``corrupt(engine, req, slot)`` runs after a hit's pages are staked (the
    control); ``expire`` queues first a request whose deadline has passed;
    ``profile`` counts the ``obs.scope`` names of one decode step once the
    queue has drained (a replayed step opens ``serve.replay`` alone);
    ``profile_prefills`` profiles the first cold and the
    first hit prefill."""
    import gc

    import torch

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import MIN_BUCKET, ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(model, net, **{**SERVE, "decode_backend": "paged",
                                        "prefix_cache": cache, **kw}, cuda_graph=graph)
    if graph:
        engine.warmup(max_prompt_len=MIN_BUCKET)
    builds = engine.stats["decode_compiles"]
    rec = record_prefills(engine, profile_prefills)
    if corrupt is not None:
        stake = engine._stake_suffix

        def staked(req, slot):
            stake(req, slot)
            corrupt(engine, req, slot)

        engine._stake_suffix = staked
    reset_launch_counts()
    t0 = time.perf_counter()
    pinned = engine.pin_prefix(template) if cache else 0
    if expire:   # first in the queue: dropped at the first admission, its holds given back
        engine.submit(prompts[-1], max_new_tokens=new, deadline_s=-1.0)
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    shared_peak, scopes, prof_s, prof_wall, first = 0, None, 0.0, 0.0, None
    while True:
        if profile and scopes is None and not engine.sched.waiting and engine.sched.running:
            s0, w0 = engine.stats["decode_s"], time.perf_counter()
            scopes = scope_counts(engine.step, ("kernels.paged_attention", "serve.decode",
                                                "serve.sample", "serve.replay"))
            prof_s, prof_wall = engine.stats["decode_s"] - s0, time.perf_counter() - w0
            more = engine.sched.has_work()
        else:
            more = engine.step()
        if first is None and engine.last_logits is not None:
            first = (engine.last_logits.float().clone(),
                     sorted({slot for _, slot in engine.sched.admission_log}))
        engine.check_invariants()
        shared_peak = max(shared_peak, engine.alloc.shared_blocks())
        if not more:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - prof_wall
    counts = launch_counts()
    st = engine.stats
    engine.release_pins()
    engine.check_invariants()
    pool = engine.alloc.stats()
    done = {r.rid: r.tokens for r in engine.sched.finished}
    ms = {k: sum(v) / len(v) if v else float("nan") for k, v in rec["ms"].items()}
    steps = max(1, st["decode_steps"] - (scopes is not None))
    out = {"label": label, "tokens": [done[r] for r in rids], "counts": counts, "stats": st,
           "first": [rec["logits"][r] for r in rids], "graph": graph,
           "first_logits": first and first[0], "first_slots": first and first[1],
           "warmup_s": st["warmup_s"], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "hits": [i for i, r in enumerate(rids) if rec["hit"][r]],
           "cold_ms": ms["cold"], "hit_ms": ms["hit"],
           "step_ms": 1e3 * (st["decode_s"] - prof_s) / steps,
           "tok_s": st["tokens_generated"] / wall, "shared_peak": shared_peak, "scopes": scopes}
    print(f"serve prefix {label}: {len(rids)} requests (+{pinned and 1} pin probe, "
          f"{st['dropped']} dropped), {st['tokens_generated']} tokens in {wall:.2f} s "
          f"({out['tok_s']:.1f} tok/s); prefill ms a request: cold {ms['cold']:.2f} "
          f"(x{len(rec['ms']['cold'])}), hit {ms['hit']:.2f} (x{len(rec['ms']['hit'])}); decode "
          f"{out['step_ms']:.3f} ms/step over {st['decode_steps']} steps; latency p50/p99 "
          f"{st['latency_p50_s'] * 1e3:.1f}/{st['latency_p99_s'] * 1e3:.1f} ms; page waits "
          f"{st['page_waits']}; resident peak {st['admitted_peak']}/{SERVE['slots']}; shared "
          f"pages peak {shared_peak} ({pinned} pinned); cow copies {st['cow_copies']}; hit rate "
          f"{st['prefix_hit_rate']:.4f}; coalesced prefills {st['coalesced_prefills']}; paged "
          f"launches {counts['paged_attention']} ({counts['paged_attention'] / steps:g} a "
          f"step); host syncs/step {st['host_syncs_per_step']}; "
          f"{'graph' if graph else 'eager'}: decode builds {builds} after warmup "
          f"({st['warmup_s']:.2f} s), {st['decode_compiles']} after serving; peak "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    out["replayed"] = engine._graph is not None
    if (builds, st["decode_compiles"]) != ((1, 1) if graph else (0, 0)) or (
            graph and engine.device.type == "cuda" and not out["replayed"]):
        raise AssertionError(f"{label}: decode builds {builds} after warmup, "
                             f"{st['decode_compiles']} after serving, graph captured "
                             f"{out['replayed']}")
    if pool["blocks_free"] != pool["blocks_total"] or pool["blocks_reserved"] or engine.alloc._ref:
        raise AssertionError(f"{label}: references left after the drain: {pool}")
    if st["finished"] != len(rids) + (pinned > 0) or st["dropped"] != expire:
        raise AssertionError(f"{label}: finished {st['finished']}, dropped {st['dropped']}")
    want = model.cfg.num_layers * st["decode_steps"]
    if counts["paged_attention"] != want or any(n for k, n in counts.items()
                                                if k != "paged_attention"):
        raise AssertionError(f"{label}: launches {counts}, expected {want} paged")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def first_logits_rel(label: str, pairs, tol: float) -> float:
    """The worst of max |got - want| over max |want| on (got, want) pairs of
    first-token logits; printed beside ``tol`` (the caller decides)."""
    rels = [max_err(got, want) / want.abs().max().item() for got, want in pairs]
    worst = max(rels)
    print(f"serve prefix {label}: first-token logits of {len(rels)} requests, worst rel "
          f"{worst:.4g} (request {rels.index(worst)}; limit {tol:g})", flush=True)
    return worst


def bucketed(prompt, dev) -> dict:
    """One right-padded request batch of ``prompt`` at its prefill bucket."""
    import torch

    bucket = 8
    while bucket < len(prompt):
        bucket *= 2
    tokens = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    tokens[0, :len(prompt)] = torch.from_numpy(prompt).to(dev)
    return {"tokens": tokens, "lengths": torch.tensor([len(prompt)], dtype=torch.int32,
                                                      device=dev)}


def kv_rows_bitwise(model, net, template, prompt) -> None:
    """Layer 0's and the last layer's template K/V rows from cold prefills of
    the template alone and of a longer prompt (two prefill widths), compared
    bitwise."""
    dev = next(net.parameters()).device
    caches = [model.prefill(net, bucketed(p, dev), SERVE["capacity"])[1]
              for p in (template, prompt)]
    n = len(template)
    for layer in (0, len(caches[0].layers) - 1):
        for name in ("k", "v"):
            x = getattr(caches[0].layers[layer], name)[:, :, :n]
            y = getattr(caches[1].layers[layer], name)[:, :, :n]
            print(f"  layer {layer} {name}: {int((x != y).sum())} of {x.numel()} template "
                  f"values differ between prefill widths {len(template)} and {len(prompt)} "
                  f"(max abs {max_err(x, y):.3g})", flush=True)


def suffix_outside(model, net, template, prompt):
    """A hit's first-token logits computed outside the engine: the
    template's cold prefill into dense caches, then ``prefill_suffix`` of
    the rest (of the last token alone where the prompt is the template), as
    the engine splits it where the tail's blocks are not cached."""
    import torch

    dev = next(net.parameters()).device
    caches = model.prefill(net, bucketed(template, dev), SERVE["capacity"])[1]
    offset = len(template) - 1 if len(prompt) == len(template) else len(template)
    batch = bucketed(prompt[offset:], dev)
    batch["offsets"] = torch.tensor([offset], dtype=torch.int32, device=dev)
    return model.prefill_suffix(net, batch, caches)[0][0].float()


def prefix_phase(cfg, model, net) -> int:
    """Qwen2-1.5B at full width and depth served with the prefix cache (the
    kernel route): the shared-template workload in bf16 with the cache off
    and on, the hits' first-token logits against the cold run's, a
    corrupted shared page as the control, the coalesced cache-off run, a
    traced cache-on run with one decode step's scopes counted, and fp32 on
    against off (greedy tokens). References are checked after every step of
    every run. Returns the paged kernel's launches of the cache-on run (the
    phase's main path)."""
    import tempfile

    import torch

    from repro_torch.config import replace
    from repro_torch.models.api import get_model
    from repro_torch.obs.trace import Tracer

    t_phase = time.perf_counter()
    template, prompts = prefix_workload(cfg.vocab, PREFIX_TEMPLATE, PREFIX_REQUESTS)
    print(f"serve prefix requests: a {len(template)}-token template, {len(prompts)} prompts of "
          f"{[len(p) for p in prompts]} tokens, {PREFIX_NEW} new tokens each; engine {SERVE}",
          flush=True)
    off = prefix_run(model, net, template, prompts, "bf16 cache off", cache=False,
                     new=PREFIX_NEW)
    on = prefix_run(model, net, template, prompts, "bf16 cache on", cache=True, new=PREFIX_NEW)
    print(f"serve prefix bf16 on vs off: prefill ms a request, hit {on['hit_ms']:.2f} vs cold "
          f"{off['cold_ms']:.2f}; decode ms a step {on['step_ms']:.3f} vs {off['step_ms']:.3f}; "
          f"tok/s {on['tok_s']:.1f} vs {off['tok_s']:.1f}; resident peak "
          f"{on['stats']['admitted_peak']} vs {off['stats']['admitted_peak']}", flush=True)
    failures = []
    if not on["stats"]["admitted_peak"] > off["stats"]["admitted_peak"]:
        failures.append("the cache-on run's resident peak is not above the cache-off run's")
    if not (off["stats"]["page_waits"] > 0 and on["stats"]["cow_copies"] >= 1
            and len(on["hits"]) == len(prompts)):
        failures.append(f"page waits off {off['stats']['page_waits']}, cow copies "
                        f"{on['stats']['cow_copies']}, hits {len(on['hits'])} of {len(prompts)}")
    div = first_divergence(on["tokens"], off["tokens"])
    print("serve prefix bf16 on vs off: greedy tokens "
          + ("all equal" if div is None else f"first differ at request {div[0]}, token {div[1]}"),
          flush=True)
    # check 2: every hit's first-token logits against the cold run's
    sound = first_logits_rel("bf16 hits vs cold", [(on["first"][i], off["first"][i])
                                                   for i in on["hits"]], ROUTE_TOL["bfloat16"])
    if not sound <= ROUTE_TOL["bfloat16"]:
        failures.append(f"bf16 hits' first-token logits rel {sound:.4g}")
    # the graph route's oracle: the cache-on run on the eager step, one of
    # its decode steps' scopes counted (a kernels.paged_attention a layer,
    # one serve.decode and one serve.sample, no replay)
    eager = prefix_run(model, net, template, prompts, "bf16 cache on", cache=True,
                       new=EAGER_NEW, graph=False, profile=True)
    graph_held("prefix bf16 cache on", on, eager, "bfloat16")
    eager_scopes = {"kernels.paged_attention": cfg.num_layers, "serve.decode": 1,
                    "serve.sample": 1, "serve.replay": 0}
    if eager["scopes"] != eager_scopes:
        failures.append(f"eager decode step scopes {eager['scopes']}, want {eager_scopes}")
    del eager

    # check 3, the control: request 1's first shared page given the id of
    # another live block (a pinned template block from the middle); the
    # lease follows, so the references still hold
    def corrupt(engine, req, slot):
        other = engine._pins[len(engine._pins) // 2]
        lease = engine._leases[slot]
        engine.alloc.acquire(other)
        engine.alloc.release_ref(lease.mapped[0])
        lease.mapped[0] = engine._pt[slot, 0] = other

    ctrl = prefix_run(model, net, template, prompts[1:2], "bf16 control", cache=True, new=1,
                      corrupt=corrupt, profile_prefills=True)
    control = first_logits_rel("control (request 1, page 0 -> a pinned middle block) vs cold",
                               [(ctrl["first"][0], off["first"][1])], ROUTE_TOL["bfloat16"])
    print(f"serve prefix control: sound {sound:.4g}, corrupted page {control:.4g}, limit "
          f"{ROUTE_TOL['bfloat16']:g}", flush=True)
    if not control > ROUTE_TOL["bfloat16"]:
        failures.append(f"the limit passes a corrupted shared page (rel {control:.4g})")

    # check 5: the cache-off run with coalesced prefill
    coal = prefix_run(model, net, template, prompts, "bf16 cache off coalesced", cache=False,
                      new=PREFIX_NEW, coalesce_prefill=True)
    worst = first_logits_rel("coalesced vs solo", list(zip(coal["first"], off["first"])),
                             ROUTE_TOL["bfloat16"])
    print(f"serve prefix coalesced: prefill ms a request {coal['cold_ms']:.2f} vs solo "
          f"{off['cold_ms']:.2f}", flush=True)
    if not (coal["stats"]["coalesced_prefills"] > 0 and worst <= ROUTE_TOL["bfloat16"]):
        failures.append(f"coalesced prefills {coal['stats']['coalesced_prefills']}, logits rel "
                        f"{worst:.4g}")

    # check 6: the cache-on run traced, with an expiring request, and one
    # replayed decode step's scopes counted (the graph runs no Python scope)
    tracer = Tracer()
    traced = prefix_run(model, net, template, prompts, "bf16 cache on traced", cache=True,
                        new=PREFIX_NEW, tracer=tracer, expire=True, profile=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        tracer.write(str(path))
        doc = json.loads(path.read_text())
    phases = {e["name"] for e in doc["traceEvents"]}
    need = {"enqueue", "prefix_walk", "admit", "prefill", "prefix_hit", "cow_copy", "retire",
            "expire", "decode"}
    scopes = ({"kernels.paged_attention": 0, "serve.decode": 0, "serve.sample": 0,
               "serve.replay": 1} if traced["replayed"] else eager_scopes)
    print(f"serve prefix trace: {len(doc['traceEvents'])} events, phases "
          f"{sorted(phases & need)}, missing {sorted(need - phases)}; one decode step's scopes "
          f"{traced['scopes']} (want {scopes})", flush=True)
    if need - phases or traced["scopes"] != scopes:
        failures.append(f"trace phases missing {sorted(need - phases)}, scopes {traced['scopes']}")
    if traced["tokens"] != on["tokens"]:
        failures.append("bf16 greedy tokens changed with tracing on")

    # check 1: fp32 compute, the cache on against off, and traced. Each hit's
    # first-token logits are held against the same suffix prefill run outside
    # the engine (no pages, no sharing); against the cold run they are
    # printed: in fp32 compute a hit's suffix attends over the bf16 cache with
    # its value product in bf16 (gqa_extend's staging, the JAX package's),
    # where a cold prefill attends over its own fp32 K/V
    model32 = get_model(replace(cfg, compute_dtype="float32"))
    t32, p32 = prefix_workload(cfg.vocab, PREFIX32_TEMPLATE, PREFIX32_REQUESTS)
    runs32 = {name: prefix_run(model32, net, t32, p32, f"fp32 cache {name}",
                               cache=name != "off", new=PREFIX32_NEW, graph=name != "on eager",
                               tracer=Tracer() if name == "on traced" else None)
              for name in ("off", "on", "on traced", "on eager")}
    on32, traced32 = runs32["on"], runs32["on traced"]
    graph_held("prefix fp32 cache on", on32, runs32["on eager"], "float32")
    div = first_divergence(on32["tokens"], runs32["off"]["tokens"])
    print(f"serve prefix fp32 on vs off: greedy tokens of {PREFIX32_REQUESTS} x {PREFIX32_NEW} "
          "positions " + ("all equal" if div is None else
                          f"first differ at request {div[0]}, token {div[1]}"), flush=True)
    first_logits_rel("fp32 hits vs cold (printed)",
                     [(on32["first"][i], runs32["off"]["first"][i]) for i in on32["hits"]],
                     LM_TOL["float32"])
    engine32 = first_logits_rel("fp32 hits vs the suffix prefill outside the engine",
                                [(on32["first"][i], suffix_outside(model32, net, t32, p32[i]))
                                 for i in on32["hits"]], LM_TOL["float32"])
    if not engine32 <= LM_TOL["float32"]:
        failures.append(f"fp32 hits' first-token logits rel {engine32:.4g} off the suffix "
                        "prefill outside the engine")
    if div is not None:
        kv_rows_bitwise(model32, net, t32, p32[1])
    if traced32["tokens"] != on32["tokens"] or (traced32["stats"]["host_syncs_per_step"]
                                                != on32["stats"]["host_syncs_per_step"]):
        failures.append("fp32 greedy tokens or host syncs changed with tracing on")
    print(f"serve prefix phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del model32, runs32
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("serve prefix: " + "; ".join(failures))
    return on["counts"]["paged_attention"]


# --------------------------------------------------------------------------
# The flash-attention kernel: the dense family's full-sequence forward and
# prefill (qwen2-1.5b, phi3-mini-3.8b) through attn_sdpa(impl="pallas")
# --------------------------------------------------------------------------


def flash_keep(sq: int, skv: int, *, causal: bool, window, q_offset: int = 0, device=None):
    """[Sq, Skv] bool: the keys each query row keeps under the kernel's masks."""
    import torch

    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(skv, device=device)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    return keep


def flash_dropped(q, k, v, *, t0: int, scale: float, causal: bool, window, q_offset: int = 0):
    """What a flash kernel that skipped the live KV tile [t0, t0 + 64) would
    give: the plain version's math in fp64 with those keys masked too (k and
    v of Hkv | H heads expanded, as the plain version expands them)."""
    import torch

    from repro_torch.kernels.attention import KV_TILE

    if k.shape[-3] != q.shape[-3]:
        k, v = (t.repeat_interleave(q.shape[-3] // k.shape[-3], dim=-3) for t in (k, v))
    keep = flash_keep(q.shape[-2], k.shape[-2], causal=causal, window=window,
                      q_offset=q_offset, device=q.device)
    keep[:, t0:t0 + KV_TILE] = False
    s = torch.einsum("...sd,...td->...st", q.double(), k.double()) * scale
    w = torch.nan_to_num(torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1), nan=0.0)
    return torch.einsum("...st,...td->...sd", w, v.double())


def flash_by_block(fn, q, k, v, *, chunk=None, **kw):
    """``fn`` (the plain version, or :func:`flash_dropped`) a query head at a
    time, with its KV head (h // (H / Hkv)), and, with ``chunk``, that many
    query rows at a time, each block given only the keys a causal mask can
    keep: [B, H, Sq, D]."""
    import torch

    sq, skv = q.shape[2], k.shape[2]
    groups = q.shape[1] // k.shape[1]
    step = chunk or sq
    heads = []
    for h in range(q.shape[1]):
        kv = h // groups
        rows = []
        for q0 in range(0, sq, step):
            q1 = min(sq, q0 + step)
            kend = min(skv, q1) if kw["causal"] else skv
            rows.append(fn(q[:, h:h + 1, q0:q1], k[:, kv:kv + 1, :kend], v[:, kv:kv + 1, :kend],
                           q_offset=q0, **kw))
        heads.append(torch.cat(rows, dim=2))
    return torch.cat(heads, dim=1)


def check_flash_small(checks: Checks, device) -> None:
    """The flash kernels against their plain version on random operands laid
    out as the model gives them ([B, H, S, D] views of [B, S, H, D]), H=6
    query heads over 1, 2 or 6 KV heads (MQA, GQA 3:1, MHA), unexpanded:
    D 8 / 16 / 24 / 32 / 64 / 96 / 128 x (Sq, Skv) 97/97, 300/300, 128/64 x
    causal, full, causal with a window of 24. fp32 (the TF32 kernel) against
    the plain version in fp64; bf16 on both bf16 routes (the wgmma kernel,
    which flash_route picks for these operands, and bf16_mma) against the
    plain version on the same operands, and beyond bf16's output rounding
    against the fp64 plain version (Checks.hold_rounded). Each limit must
    reject the fp64 plain version with the 64-key tile at Skv/2 left out,
    and the rows that see no key must come out exactly 0. Then the bf16
    calls flash_route itself sends off TMA (FLASH_OFF_TMA: D=100, and a
    D=128 view whose base is 8 bytes off) under the same checks, each
    launch's route asserted by count and, on a profiled window, by the
    kernel's name."""
    import torch

    from repro_torch.kernels.attention import KV_TILE, flash_attention, flash_route
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator().manual_seed(SEED + 4)
    case = 0
    for d in FLASH_D:
        for sq, skv in FLASH_LENGTHS:
            hkv = FLASH_HKV[case % len(FLASH_HKV)]
            case += 1
            base = [torch.randn(2, n, heads, d, generator=gen).transpose(1, 2)
                    for n, heads in ((sq, FLASH_H), (skv, hkv), (skv, hkv))]
            for mask_name, masks in FLASH_MASKS.items():
                kw = dict(masks, scale=d ** -0.5)
                empty = ~flash_keep(sq, skv, **masks, device=device).any(-1)
                wide = [t.to(device, torch.float64) for t in base]
                want = flash_attention_ref(*wide, **kw)
                t0 = (skv // 2) // KV_TILE * KV_TILE
                drop = {f"KV tile {t0}": flash_dropped(*wide, t0=t0, **kw)}
                print(f"kernels flash B=2 H={FLASH_H} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
                      f"{mask_name} ({int(empty.sum())} rows see no key):", flush=True)
                ops32 = [t.to(device, torch.float32) for t in base]
                ops16 = [t.to(device, torch.bfloat16) for t in base]
                # bf16 is held beyond its output rounding against fp64 on its own values
                wide16 = [t.double() for t in ops16]
                want16 = flash_attention_ref(*wide16, **kw)
                drop16 = {f"KV tile {t0}": flash_dropped(*wide16, t0=t0, **kw)}
                picked = flash_route(*ops16)
                if picked != "tensor_core":
                    checks.failures.append(f"flash D={d}: flash_route picked {picked} for "
                                           "aligned bf16 operands")
                for route, ops in (("fp32", ops32), ("tensor_core", ops16),
                                   ("bf16_mma", ops16)):
                    got = flash_attention(*ops, **kw, route=route)
                    hold_flash(checks, route, got, ops, want, want16, drop, drop16, kw)
                    if not (bool(got.isfinite().all()) and bool((got[:, :, empty] == 0).all())):
                        checks.failures.append(f"flash D={d} {sq}/{skv} {mask_name} {route}: "
                                               "non-finite output or a row with no key not 0")
    for case, d in FLASH_OFF_TMA.items():
        base = [torch.randn(2, 300, heads, d, generator=gen) for heads in (FLASH_H, 2, 2)]
        ops16 = [t.to(device, torch.bfloat16) for t in base]
        if "base" in case:   # the same values in memory 8 bytes past a 16-byte boundary
            ops16 = [torch.cat([t.new_zeros(4), t.flatten()])[4:].view(t.shape) for t in ops16]
        ops16 = [t.transpose(1, 2) for t in ops16]
        wide = [t.transpose(1, 2).to(device, torch.float64) for t in base]
        picked = flash_route(*ops16)
        if picked != "bf16_mma":
            checks.failures.append(f"flash {case}: flash_route picked {picked}, not bf16_mma")
        for mask_name, masks in FLASH_MASKS.items():
            kw = dict(masks, scale=d ** -0.5)
            print(f"kernels flash off TMA {case} B=2 H={FLASH_H} Hkv=2 Sq=Skv=300 {mask_name} "
                  f"(q strides {ops16[0].stride()}, base mod 16 bytes "
                  f"{ops16[0].data_ptr() % 16}):", flush=True)
            t0 = 150 // KV_TILE * KV_TILE
            drop = {f"KV tile {t0}": flash_dropped(*wide, t0=t0, **kw)}
            wide16 = [t.double() for t in ops16]
            want16 = flash_attention_ref(*wide16, **kw)
            drop16 = {f"KV tile {t0}": flash_dropped(*wide16, t0=t0, **kw)}
            before = dict(flash_attention.launches_by_route)
            got = flash_attention(*ops16, **kw)
            ran = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
            if ran != {r: int(r == "bf16_mma") for r in ran}:
                checks.failures.append(f"flash {case} {mask_name}: launches by route {ran}")
            hold_flash(checks, "bf16_mma", got, ops16, None, want16, drop, drop16, kw)
            if not bool(got.isfinite().all()):
                checks.failures.append(f"flash {case} {mask_name}: non-finite output")
        # the route by the profiler's kernel names, on a window of three calls
        # with a torch op after each (late in this script a window of lone
        # ctypes launches came back empty on the card)
        label = f"flash off TMA {case}"
        assert_route(breakdown(lambda: [flash_attention(*ops16, **kw).float().sum()
                                        for _ in range(3)], label, top=3),
                     label, ("flash_bf16_kernel",),
                     refuse=("flash_tc_kernel", "flash_tf32_kernel"))
    checks.raise_failures("flash kernels on random operands")


def hold_flash(checks: Checks, route: str, got, ops, want, want16, drop, drop16, kw) -> None:
    """One flash call on ``route`` held as check_flash_small holds it: fp32
    against the fp64 plain version ``want``; bf16 against the plain version
    on the same operands and beyond its output rounding against ``want16``,
    the fp64 plain version on its bf16 values. Errors count into the
    JSON line's rows: the wgmma kernel's, the file of the TF32 and bf16_mma
    kernels (fp32), and bf16_mma's own record."""
    import torch

    from repro_torch.kernels.ref import flash_attention_ref

    name = "flash_attention_tc" if route == "tensor_core" else "flash_attention"
    plain = flash_attention_ref(*ops, **kw)
    if route == "fp32":
        checks.hold(name, "o fp32", got, want, torch.float32, atol=ATOL["float32"], record=True,
                    dropped=drop, fp32_plain=plain)
        return
    record = True if route == "tensor_core" else "flash_bf16_mma"
    checks.hold(name, f"o bf16 {route}", got, plain, torch.bfloat16, atol=ATOL["bfloat16"],
                record=record, dropped=drop)
    checks.hold_rounded(name, f"o bf16 {route} vs fp64", got, want16, dropped=drop16)


def dense_tokens(vocab: int, b: int, t: int, seed: int, device, lengths=None):
    """Seeded uniform token ids [B, T] (right-padded with 0 past ``lengths``)."""
    import numpy as np
    import torch

    toks = np.random.default_rng(seed).integers(0, vocab, (b, t))
    if lengths is not None:
        toks[np.arange(t)[None, :] >= np.asarray(lengths)[:, None]] = 0
    return torch.from_numpy(toks).long().to(device)




def attention_operands(net, cfg, tokens):
    """Layer 0's rope'd q [B, H, T, D] and k, v [B, Hkv, T, D] for ``tokens``
    in the model's compute dtype: what ``gqa_forward`` gives ``attn_sdpa``
    on the pallas route (the KV heads unexpanded), strided views and all."""
    import torch

    from repro_torch.models import attention, transformer

    with torch.no_grad():
        layer = net.layers[0]
        x = transformer._norm(cfg, layer.norm1, transformer._embed(net, tokens, cfg))
        positions = transformer._positions(cfg, *tokens.shape, tokens.device)
        return attention._qkv(layer.attn, x, cfg.attn, positions)


def check_flash_main(checks: Checks, label: str, ops16, scale: float, *,
                     causal: bool = True) -> None:
    """The flash kernels on a model's attention operands (layer 0's, or a
    shared block's invocation's), as its prefill gives them (the KV heads
    unexpanded), causal or not, Sq and Skv equal or not: widened to fp32
    (the TF32 kernel's route)
    against the plain version in fp64, a head and 4,096 queries at a time,
    relative to max |plain|; the limit must reject the fp64 plain version
    with the 64-key tile at Skv/2 left out. bf16, as the model runs it (the
    tensor cores: the route is asserted), against the plain version on the
    same operands, and beyond its output rounding against the fp64 plain
    version, where the same lost tile must be rejected too."""
    import functools

    import torch

    from repro_torch.kernels.attention import KV_TILE, flash_attention, flash_route
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = ops16
    b, h, n, d = q.shape
    skv = k.shape[2]
    kw = dict(scale=scale, causal=causal, window=None)
    lengths = f"T={n}" if skv == n else f"Sq={n} Skv={skv}"
    print(f"kernels flash {label} (B={b} H={h} Hkv={k.shape[1]} {lengths} D={d}"
          f"{'' if causal else ', no mask'}, q/k/v strides {q.stride()}/{k.stride()}; fp32 "
          "held against the plain version in fp64):", flush=True)
    ops32 = [t.float() for t in ops16]
    got = flash_attention(*ops32, **kw)
    wide = [t.double() for t in ops16]
    want = flash_by_block(flash_attention_ref, *wide, chunk=FLASH_QCHUNK, **kw)
    t0 = skv // 2 // KV_TILE * KV_TILE
    drop = {f"KV tile {t0}": flash_by_block(functools.partial(flash_dropped, t0=t0), *wide,
                                            chunk=FLASH_QCHUNK, **kw)}
    del wide
    plain32 = flash_by_block(flash_attention_ref, *ops32, chunk=FLASH_QCHUNK, **kw)
    checks.hold("flash_attention", "o fp32", got, want, torch.float32, atol=None, record=True,
                dropped=drop, fp32_plain=plain32)
    del got, plain32, ops32
    route = flash_route(q, k, v)
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, **kw)
    ran = {r: c - before[r] for r, c in flash_attention.launches_by_route.items()}
    print(f"  bf16 route: {route}; launches by route {ran}", flush=True)
    if route != "tensor_core" or ran["tensor_core"] != 1:
        checks.failures.append(f"{label}: bf16 operands took route {route} ({ran}), not the "
                               "tensor cores")
    checks.hold("flash_attention_tc", "o bf16", got,
                flash_by_block(flash_attention_ref, q, k, v, chunk=FLASH_QCHUNK, **kw),
                torch.bfloat16, atol=None, record=True)
    checks.hold_rounded("flash_attention_tc", "o bf16 vs fp64", got, want, dropped=drop)
    del got, want, drop
    torch.cuda.empty_cache()
    checks.raise_failures(f"flash kernels on {label}'s operands")


def visible_pairs(sq: int, skv: int, *, causal: bool, window) -> int:
    """(query, key) pairs the masks keep: the work a call needs."""
    import numpy as np

    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(r, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, r - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())




def sdpa_ms(q, k, v, scale: float, reps: int, *, causal: bool = True):
    """``F.scaled_dot_product_attention`` (the yardstick; the port never calls
    it), causal or not, on K and V expanded to q's heads beforehand (not timed);
    any backend but the math one, which would materialise every score (fp32:
    the memory-efficient one, TF32 off). None where they all refuse the call
    (bf16 at D % 8 != 0)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    groups = q.shape[1] // k.shape[1]
    kx, vx = (t.repeat_interleave(groups, 1) for t in (k, v))
    call = lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=causal, scale=scale)
    backends = [SDPBackend.EFFICIENT_ATTENTION]
    if q.dtype == torch.bfloat16:
        backends += [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]
    try:
        with sdpa_kernel(backends):
            return cuda_ms(call, reps=reps)
    except RuntimeError as err:
        print(f"  SDPA on {q.dtype} D={q.shape[-1]}: every backend but the math one refused "
              f"({str(err)[:200]}); not measured", flush=True)
        return None


def time_flash(ops16, scale: float) -> dict:
    """CUDA-event times on qwen2's layer 0 operands (causal, the KV heads
    unexpanded). bf16: the wgmma kernel and the bf16_mma kernel (forced onto
    these operands), in one call and in turns (bf16_mma, wgmma, wgmma,
    bf16_mma), their plain version (a head at a
    time), ``attn_sdpa``'s chunked route (what "auto" runs at 32k) and SDPA;
    the bound is 4 * D FLOP a kept (query, key) pair over the bf16 peak (the
    two products), or q, k, v and o once over 3.35 TB/s, and beside it the
    split P's bound (its third product: 1.5x). fp32 (the TF32 tensor-core
    kernel, flash_tf32_kernel): the kernel, its plain version and SDPA,
    bound by the fp32 CUDA-core rate (the work of any fp32 implementation),
    and beside it the two floors of its design: its products split three
    ways at the TF32 peak, and its exps (one a kept pair) at 16 a clock an
    SM at the card's top SM clock. The bf16_mma route's own record (the
    ``flash_attention`` row's ``off_tma_bf16``): its time at qwen2's layer
    0, beside the same bound, its split products at the bf16 peak and its
    exps, and on an off-TMA call of the same geometry at D=OFF_TMA_D
    (random operands, flash_route's own pick, profiled: the route must name
    flash_bf16_kernel). Returns the stats of both kernels' rows."""
    import torch

    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import attn_sdpa

    q, k, v = ops16
    b, h, n, d = q.shape
    hkv = k.shape[1]
    kw = dict(scale=scale, causal=True, window=None)
    flops = 4 * d * b * h * visible_pairs(n, n, causal=True, window=None)
    elems = b * d * n * 2 * (h + hkv)     # q and o, k and v, once each
    rows = {}
    for name, ops, peak in (("flash_attention_tc", ops16, PEAK_BF16),
                            ("flash_attention", [t.float() for t in ops16], PEAK_FP32)):
        nbytes = elems * ops[0].element_size()
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BW * 1e3
        rows[name] = dict(plain_ms=cuda_ms(lambda: flash_by_block(flash_attention_ref, *ops, **kw),
                                           reps=1),
                          library_ms=sdpa_ms(*ops, scale, reps=10 if peak == PEAK_BF16 else 2),
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes else "bytes")
    tc = lambda: flash_attention(q, k, v, **kw)
    mma = lambda: flash_attention(q, k, v, **kw, route="bf16_mma")
    turns = [cuda_ms(mma, reps=3), cuda_ms(tc, reps=5), cuda_ms(tc, reps=5), cuda_ms(mma, reps=3)]
    rows["flash_attention_tc"]["ms"] = (turns[1] + turns[2]) / 2
    ops32 = [t.float() for t in ops16]
    rows["flash_attention"]["ms"] = cuda_ms(lambda: flash_attention(*ops32, **kw), reps=3)
    pairs = b * h * visible_pairs(n, n, causal=True, window=None)
    floors = dict(products=3 * flops / PEAK_TF32 * 1e3,
                  exps=pairs / (16 * 132 * max_sm_clock_mhz() * 1e6) * 1e3)
    rows["flash_attention"].update(floor_split_products_ms=floors["products"],
                                   floor_exps_ms=floors["exps"])
    chunked_ms = cuda_ms(lambda: attn_sdpa(q, k.repeat_interleave(h // hkv, 1),
                                           v.repeat_interleave(h // hkv, 1), impl="chunked",
                                           **kw), reps=1)
    print(f"time flash_attention_tc qwen2-1.5b layer 0 bf16 (B={b} H={h} Hkv={hkv} T={n} "
          f"D={d}): {rows['flash_attention_tc']}; in turns: bf16_mma {turns[0]:.3f} ms, "
          f"wgmma {turns[1]:.3f} ms, wgmma {turns[2]:.3f} ms, bf16_mma "
          f"{turns[3]:.3f} ms; bounds: two products {flops / PEAK_BF16 * 1e3:.3f} ms, with the "
          f"split P's third {1.5 * flops / PEAK_BF16 * 1e3:.3f} ms; attn_sdpa chunked "
          f"{chunked_ms:.3f} ms ({flops / 1e12:.3f} TFLOP)", flush=True)
    tc_row = rows["flash_attention_tc"]
    off = dict(kernel="flash_bf16_kernel", ms=(turns[0] + turns[3]) / 2,
               plain_ms=tc_row["plain_ms"], library_ms=tc_row["library_ms"],
               bound_ms=tc_row["bound_ms"], bound_by=tc_row["bound_by"],
               floor_split_products_ms=1.5 * flops / PEAK_BF16 * 1e3,
               floor_exps_ms=floors["exps"])
    off.update(time_off_tma(b, h, hkv, n, q.device, kw))
    rows["flash_attention"]["off_tma_bf16"] = off
    print(f"time flash_attention bf16_mma (flash_bf16_kernel, off TMA's route): {off}",
          flush=True)
    r32 = rows["flash_attention"]
    sdpa32 = "not measured" if r32["library_ms"] is None else f"{r32['library_ms']:.3f} ms"
    print(f"time flash_attention qwen2-1.5b layer 0 fp32 (the TF32 tensor cores, "
          f"flash_tf32_kernel): {r32['ms']:.3f} ms; bound {r32['bound_ms']:.3f} ms "
          f"({r32['bound_by']}, the fp32 CUDA cores); floors: split products "
          f"{floors['products']:.3f} ms, exps {floors['exps']:.3f} ms; plain "
          f"{r32['plain_ms']:.3f} ms; SDPA (memory-efficient, fp32) {sdpa32}", flush=True)
    return rows


def time_off_tma(b: int, h: int, hkv: int, n: int, device, kw: dict) -> dict:
    """The bf16_mma route on a call flash_route itself sends off TMA: random
    bf16 operands of qwen2's layer-0 geometry at D=OFF_TMA_D (the model's
    [B, H, T, D] views), causal. Its time, SDPA's where a backend takes it,
    the bound of its two products at the bf16 peak (check_flash_small shows
    its kernel by name)."""
    import torch

    from repro_torch.kernels.attention import flash_attention, flash_route

    d = OFF_TMA_D
    gen = torch.Generator().manual_seed(SEED + 7)
    q, k, v = (torch.randn(b, n, heads, d, generator=gen).to(device, torch.bfloat16)
               .transpose(1, 2) for heads in (h, hkv, hkv))
    kw = dict(kw, scale=d ** -0.5)
    if flash_route(q, k, v) != "bf16_mma":
        raise AssertionError(f"D={d}: flash_route picked {flash_route(q, k, v)}")
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), reps=3)
    flops = 4 * d * b * h * visible_pairs(n, n, causal=True, window=None)
    return {f"ms_d{d}": ms, f"library_ms_d{d}": sdpa_ms(q, k, v, kw["scale"], reps=3),
            f"bound_ms_d{d}": flops / PEAK_BF16 * 1e3}


def dense_prefill(net, cfg, batch: dict, capacity: int, impl: str, label: str) -> dict:
    """One counted window: launch counts zeroed just before one lm_prefill
    and read just after; ms (host clock around synchronized work) and peak
    GiB. Raises unless it launched one flash kernel a layer (pallas), all on
    the route the compute dtype gives (the tensor cores for bf16, the fp32
    route for fp32), or none (other routes), and nothing else."""
    import torch

    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import transformer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = transformer.lm_prefill(net, batch, cfg, capacity, impl=impl)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts, routes = launch_counts(), dict(flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated() / 2**30
    b, t = batch["tokens"].shape
    print(f"path {label} prefill impl={impl} B={b} T={t} {cfg.compute_dtype}: {ms:.3f} ms, peak "
          f"{peak:.2f} GiB, logits {tuple(logits.shape)}; launches {counts}, flash routes "
          f"{routes}", flush=True)
    want = cfg.num_layers if impl == "pallas" else 0
    route = "tensor_core" if cfg.compute_dtype == "bfloat16" else "fp32"
    if counts["flash_attention"] != want or routes[route] != want or any(
            c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"{label} prefill impl={impl}: launches {counts}, routes {routes}; "
                             f"expected {want} flash kernels on the {route} route")
    if tuple(logits.shape) != (b, cfg.vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"{label} prefill logits {tuple(logits.shape)} not finite or "
                             "mis-shaped")
    return {"logits": logits, "caches": caches, "ms": ms, "peak": peak, "counts": counts,
            "routes": routes}


def greedy_after(net, cfg, run: dict, steps: int):
    """``steps`` greedy decode steps from a prefill's caches: logits
    [B, steps + 1, V] and tokens [B, steps + 1] (the first from the prefill)."""
    import torch

    from repro_torch.models import transformer

    outs, caches = [run["logits"]], run["caches"]
    with torch.no_grad():
        for _ in range(steps):
            logits, caches = transformer.lm_decode_step(net, outs[-1].argmax(-1)[:, None],
                                                        caches, cfg)
            outs.append(logits)
    logits = torch.stack(outs, 1)
    return logits, logits.argmax(-1)



def decode_routes_agree(net, cfg, batch: dict, label: str) -> None:
    """fp32 compute: prefill through the flash kernel and through the xla
    route, then DENSE_DECODE greedy steps from each one's caches: the same
    tokens, the prefill logits within 1e-3 of max |logit|."""
    import torch

    capacity = batch["tokens"].shape[1] + DENSE_DECODE
    runs = {impl: dense_prefill(net, cfg, batch, capacity, impl, label)
            for impl in ("pallas", "xla")}
    held(f"{label} prefill pallas vs xla fp32 (last-token logits)", runs["pallas"]["logits"],
         runs["xla"]["logits"], LM_TOL["float32"])
    got, got_tok = greedy_after(net, cfg, runs["pallas"], DENSE_DECODE)
    want, want_tok = greedy_after(net, cfg, runs["xla"], DENSE_DECODE)
    del runs
    err = max_err(got, want) / want.abs().max().item()
    print(f"{label} fp32: {DENSE_DECODE} greedy decode steps after each prefill, logits rel "
          f"{err:.3g}, tokens {'equal' if torch.equal(got_tok, want_tok) else 'DIFFER'}: "
          f"{got_tok.tolist()}", flush=True)
    if not torch.equal(got_tok, want_tok):
        raise AssertionError(f"{label}: greedy tokens after the pallas prefill differ from "
                             "those after the xla prefill")
    torch.cuda.empty_cache()




def flash_phases(checks: Checks, device, cfg, net) -> dict:
    """Qwen2-1.5B prefill through the flash kernels: both on layer 0's own
    operands at T=32,768 and their times; lm_prefill(impl="pallas") at B=1,
    T=32,768 (a counted window: 28 tensor-core launches) against the chunked
    route in bf16 with a profiler breakdown; lm_forward(impl="pallas") in
    fp32 at B=2, T=4,096 (a counted window: 28 launches on the fp32 route)
    against the xla route; greedy decode after a pallas and an xla prefill
    in fp32. Returns the two kernels' stats with the launches of the counted
    windows."""
    import torch

    from repro_torch.config import SHAPES, replace
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import transformer

    n = SHAPES["prefill_32k"].seq_len
    scale = cfg.attn.head_dim ** -0.5
    tokens = dense_tokens(cfg.vocab, 1, n, SEED, device)
    ops16 = attention_operands(net, cfg, tokens)
    check_flash_main(checks, "qwen2-1.5b layer 0", ops16, scale)
    stats = time_flash(ops16, scale)
    del ops16
    torch.cuda.empty_cache()

    batch = {"tokens": tokens}
    run = dense_prefill(net, cfg, batch, n, "pallas", "qwen2-1.5b")
    stats["flash_attention_tc"]["launches"] = run["routes"]["tensor_core"]
    stats["flash_attention"]["off_tma_bf16"]["launches"] = run["routes"]["bf16_mma"]
    logits = run.pop("logits")
    del run
    with torch.no_grad():
        assert_route(breakdown(lambda: transformer.lm_prefill(net, batch, cfg, n, impl="pallas"),
                               f"qwen2-1.5b prefill pallas B=1 T={n} bf16"),
                     "qwen2-1.5b prefill pallas bf16", ("flash_tc_kernel",),
                     refuse=("flash_bf16_kernel", "flash_tf32_kernel"))
    want = dense_prefill(net, cfg, batch, n, "chunked", "qwen2-1.5b")["logits"]
    held("qwen2-1.5b prefill pallas vs chunked bf16 (last-token logits)", logits, want,
         LM_TOL["bfloat16"])
    del logits, want, batch, tokens
    torch.cuda.empty_cache()

    cfg32 = replace(cfg, compute_dtype="float32")
    toks = dense_tokens(cfg.vocab, DENSE_B, DENSE_T, SEED + 1, device)
    with torch.no_grad():
        reset_launch_counts()
        got, _ = transformer.lm_forward(net, toks, cfg32, impl="pallas")
        counts, routes = launch_counts(), dict(flash_attention.launches_by_route)
        want, _ = transformer.lm_forward(net, toks, cfg32, impl="xla")
    print(f"path qwen2-1.5b forward impl=pallas B={DENSE_B} T={DENSE_T} fp32: logits "
          f"{tuple(got.shape)}; launches {counts}, flash routes {routes}", flush=True)
    if counts["flash_attention"] != cfg.num_layers or routes["fp32"] != cfg.num_layers or any(
            c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"qwen2-1.5b forward launches {counts}, routes {routes}")
    stats["flash_attention"]["launches"] = routes["fp32"]
    stats["flash_attention"]["off_tma_bf16"]["launches"] += routes["bf16_mma"]
    held("qwen2-1.5b forward pallas vs xla fp32 (all logits)", got[..., :cfg.vocab],
         want[..., :cfg.vocab], LM_TOL["float32"])
    del got, want
    with torch.no_grad():
        assert_route(breakdown(lambda: transformer.lm_forward(net, toks, cfg32, impl="pallas"),
                               f"qwen2-1.5b forward pallas B={DENSE_B} T={DENSE_T} fp32"),
                     "qwen2-1.5b forward pallas fp32", ("flash_tf32_kernel",),
                     refuse=("flash_bf16_kernel", "flash_tc_kernel"))
    torch.cuda.empty_cache()
    decode_routes_agree(net, cfg32, {"tokens": dense_tokens(cfg.vocab, DENSE_B, DENSE_T, SEED + 1,
                                                            device, DENSE_LENGTHS),
                                     "lengths": torch.tensor(DENSE_LENGTHS, device=device)},
                        "qwen2-1.5b")
    return stats


def phi3_serve(checks: Checks, cfg, net) -> dict:
    """Phi-3-mini (D=96) served from the paged pool in fp32 compute: the paged
    kernel on layer 0's decode read (captured from the wrapper's first call
    in an uncounted engine step) against fp64, held as qwen2's is
    (check_paged_main); then PHI3_REQUESTS requests through ServeEngine's
    dense pool and the paged pool's kernel route by graph replay (counted
    windows: 32 paged launches a decode step on the kernel route, none on
    the dense pool), the greedy tokens equal, and equal to the kernel
    route's eager oracle. Returns the read's stats with the kernel route's
    launches."""
    import torch

    from repro_torch.config import replace
    from repro_torch.models.api import get_model

    model32 = get_model(replace(cfg, compute_dtype="float32"))
    reqs = serve_requests(cfg.vocab, PHI3_REQUESTS, (PHI3_NEW, PHI3_NEW), longest_first=False,
                          lens=PHI3_PROMPTS)
    print(f"requests: {len(reqs)} prompts of {[len(p) for p, _ in reqs]} tokens, {PHI3_NEW} new "
          f"tokens each; engine {PHI3_SERVE}", flush=True)
    stats = check_paged_main(checks, "phi3-mini-3.8b decode read layer 0",
                             capture_decode_read(model32, net, reqs, PHI3_SERVE))
    runs = {name: serve_run(model32, net, reqs, f"fp32 {name}", base=PHI3_SERVE,
                            profile=name == "paged", **kw)
            for name, kw in (("dense", ROUTES["dense"]), ("paged", ROUTES["paged"]))}
    if runs["paged"]["backend"] == runs["dense"]["backend"] or runs["paged"]["per_step"] != \
            cfg.num_layers:
        raise AssertionError(f"phi3 kernel route: backend {runs['paged']['backend']}, "
                             f"{runs['paged']['per_step']} paged launches a step")
    first_step_held("phi3 fp32 paged", runs["paged"], runs["dense"], ROUTE_TOL["float32"])
    div = first_divergence(runs["paged"]["tokens"], runs["dense"]["tokens"])
    if div is not None:
        raise AssertionError(f"phi3 fp32 paged: greedy tokens differ from the dense pool's at "
                             f"request {div[0]}, token {div[1]}")
    print(f"serve phi3-mini-3.8b fp32: the greedy tokens of all {PHI3_REQUESTS} x {PHI3_NEW} "
          "positions are equal on the dense pool and the paged kernel route", flush=True)
    graph_held("phi3-mini-3.8b fp32 paged", runs["paged"],
               serve_run(model32, net, reqs, "fp32 paged", base=PHI3_SERVE, graph=False,
                         profile=True, **ROUTES["paged"]), "float32")
    stats["launches"] = runs["paged"]["counts"]["paged_attention"]
    del runs, model32
    torch.cuda.empty_cache()
    return stats


def phi3_phases(checks: Checks, device) -> dict:
    """Phi-3-mini at full width and depth from seed 0 (the seconds to draw
    its 3.8B weights printed): the flash kernels at D=96 on layer 0's own
    operands for the prefill's tokens; lm_prefill(impl="pallas") at B=2,
    T=4,096 with right-padded lengths in bf16 (a counted window: 32
    tensor-core launches; ms, peak GiB, a profiler breakdown) against the
    xla route; then in fp32 compute, against the xla route and with greedy
    decode after each prefill; then served from the paged pool through the
    paged kernel (:func:`phi3_serve`). Returns the counted windows' launches
    (flash_attention_tc: the bf16 prefill's; paged_attention: the kernel
    route's) and the paged read's stats."""
    import torch

    from repro_torch.config import replace
    from repro_torch.models import transformer

    cfg, _, net = init_dense_lm("phi3_mini_3_8b", PHI3_SIZE, on_card=True)
    batch = {"tokens": dense_tokens(cfg.vocab, DENSE_B, DENSE_T, SEED + 2, device, DENSE_LENGTHS),
             "lengths": torch.tensor(DENSE_LENGTHS, device=device)}
    check_flash_main(checks, "phi3-mini-3.8b layer 0",
                     attention_operands(net, cfg, batch["tokens"]), cfg.attn.head_dim ** -0.5)
    run = dense_prefill(net, cfg, batch, DENSE_T, "pallas", "phi3-mini-3.8b")
    launches = run["routes"]["tensor_core"]
    with torch.no_grad():
        breakdown(lambda: transformer.lm_prefill(net, batch, cfg, DENSE_T, impl="pallas"),
                  f"phi3-mini-3.8b prefill pallas B={DENSE_B} T={DENSE_T} bf16")
    want = dense_prefill(net, cfg, batch, DENSE_T, "xla", "phi3-mini-3.8b")["logits"]
    held("phi3-mini-3.8b prefill pallas vs xla bf16 (last-token logits)", run["logits"], want,
         LM_TOL["bfloat16"])
    del run, want
    torch.cuda.empty_cache()
    decode_routes_agree(net, replace(cfg, compute_dtype="float32"), batch, "phi3-mini-3.8b")
    paged = phi3_serve(checks, cfg, net)
    del net
    torch.cuda.empty_cache()
    return {"flash_attention_tc": launches, "paged_attention": paged}


def baseline_net(cfg, mixer: str, device):
    """A Table-1 surrogate at ``cfg``'s width and depth, drawn from seed 0."""
    import torch

    from repro_torch.models import pde

    return pde.init_surrogate(mixer, in_dim=3, out_dim=1, dim=cfg.d_model,
                              num_blocks=cfg.num_layers, num_heads=cfg.flare_heads,
                              num_latents=cfg.flare_latents,
                              generator=torch.Generator().manual_seed(SEED), device=device)


def attention_calls(cfg, mixer: str) -> int:
    """The attention calls of one forward: one a block; the Perceiver's
    encode, latent blocks and decode."""
    return cfg.num_layers + 2 if mixer == "perceiver" else cfg.num_layers


def lose_rows(attend, call: int, n: int):
    """``attend`` with the last ``n`` rows of its ``call``-th output (1-based,
    counted over one forward) zeroed: a lost chunk (tokens; the Transolver's
    rows are slices)."""
    import torch

    seen = [0]

    def lossy(q, k, v):
        out = attend(q, k, v)
        seen[0] += 1
        if seen[0] != call:
            return out
        keep = torch.ones(out.shape[-2], 1, dtype=out.dtype, device=out.device)
        keep[-n:] = 0
        return out * keep

    return lossy


def exact_zero_grad(name: str) -> bool:
    """Leaves whose exact gradient is zero: a key bias (the softmax cancels a
    shift of every key) and the Perceiver's unread enc/dec ln2 and mlp."""
    return name.endswith("wk.bias") or any(
        name.startswith(f"perceiver.{p}.{leaf}.") for p in ("enc", "dec") for leaf in ("ln2", "mlp"))


def loss_grads(net, batch, mixer: str, heads: int, attend) -> dict:
    """{leaf: the gradient of surrogate_loss} (zeros where no path reads it)."""
    import torch

    from repro_torch.models.pde import surrogate_loss

    net.zero_grad(set_to_none=True)
    surrogate_loss(net, batch, mixer=mixer, num_heads=heads, attend=attend).backward()
    out = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
           for k, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return out


def leaf_rels(grads: dict, want: dict) -> list:
    """[(error over the leaf's max |g| (a leaf whose exact gradient is zero:
    over the tree's), leaf, its max |g|)], the largest first."""
    tree = max(w.abs().max().item() for w in want.values())
    out = []
    for name, w in want.items():
        peak = w.abs().max().item()
        out.append((max_err(grads[name], w) / (tree if exact_zero_grad(name) else peak),
                    name, peak))
    return sorted(out, reverse=True)


def check_baseline(cfg, mixer: str, device) -> list:
    """``mixer`` at full width on one Darcy example at N=4,096: the forward
    (SDPA's memory-efficient kernel, fp32) and the gradients of
    surrogate_loss against the fp64 plain oracle on the same weights, each
    with the oracle that lost the last LOST_CHUNK rows of its last attention
    call rejected; the fp32 plain route's reading printed beside. Returns
    the failures."""
    import copy

    import torch

    from repro_torch.data.pde_data import darcy_batch
    from repro_torch.models.pde import attention, plain_attention, surrogate_forward

    heads, calls = cfg.flare_heads, attention_calls(cfg, mixer)
    net = baseline_net(cfg, mixer, device)
    net64 = copy.deepcopy(net).double()
    batch = darcy_batch(SEED, 2, 1, grid=BASE_CHECK_GRID)
    b64 = {k: v.double() for k, v in batch.items()}
    lost = lambda: lose_rows(plain_attention, calls, LOST_CHUNK)
    with torch.no_grad():
        fwd = lambda m, b, attend: surrogate_forward(m, b["x"], mixer=mixer, num_heads=heads,
                                                     attend=attend)
        y64 = fwd(net64, b64, plain_attention)
        scale = y64.abs().max().item()
        rel, rel_plain, rel_lost = (max_err(fwd(*a), y64) / scale for a in (
            (net, batch, attention), (net, batch, plain_attention), (net64, b64, lost())))
    want = loss_grads(net64, b64, mixer, heads, plain_attention)
    g = leaf_rels(loss_grads(net, batch, mixer, heads, attention), want)
    g_plain = leaf_rels(loss_grads(net, batch, mixer, heads, plain_attention), want)
    g_lost = leaf_rels(loss_grads(net64, b64, mixer, heads, lost()), want)
    n = batch["x"].shape[1]
    top = lambda rows: ", ".join(f"{name} {r:.3g} (max|g| {peak:.3g})" for r, name, peak in rows[:3])
    print(f"check {mixer} B=1 N={n} vs fp64 plain: forward max|y| {scale:.4g} rel {rel:.3g} "
          f"(limit {BASE_FWD_TOL:g}) [fp32 plain: rel {rel_plain:.3g}], lost {LOST_CHUNK} rows "
          f"of call {calls}: rel {rel_lost:.3g}", flush=True)
    print(f"  grads over each leaf's max |g| (tree max "
          f"{max(w.abs().max().item() for w in want.values()):.4g}; limit "
          f"{BASE_GRAD_TOL:g}): {top(g)}\n  [fp32 plain: {top(g_plain)}]\n  lost: {top(g_lost)}",
          flush=True)
    failures = []
    if not (math.isfinite(rel) and rel <= BASE_FWD_TOL < rel_lost):
        failures.append(f"{mixer} forward rel {rel:.3g}, lost {rel_lost:.3g} "
                        f"(limit {BASE_FWD_TOL})")
    if not (math.isfinite(g[0][0]) and g[0][0] <= BASE_GRAD_TOL < g_lost[0][0]):
        failures.append(f"{mixer} grads rel {g[0][0]:.3g} ({g[0][1]}), lost {g_lost[0][0]:.3g}")
    return failures


def aten_ops(fn) -> dict:
    """{aten op: calls} that one call of ``fn`` dispatches, its backward's
    included, counted by a dispatch mode (no profiler session)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return dict(count.ops)


def table1_row(checks: Checks, cfg, mixer: str, batch, device) -> dict:
    """TABLE1's AdamW steps of ``mixer`` through ``make_train_step`` over
    ``surrogate_loss`` (FLARE: ``get_model``'s loss under its ``packed``
    train plan) in one counted window; ms a step (median of steps 2-5), ms a
    forward, peak GiB, parameters, losses. FLARE's fused forward and
    backward are first held on block 0's operands at this shape (its own
    split geometry) against the fp64 plain version, a lost tile rejected.
    A baseline's profiled step shows SDPA's memory-efficient kernels (no
    materialised softmax beside the Transolver's own), and one more step
    dispatches their ops once a call each way."""
    import statistics

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.models.pde import surrogate_forward, surrogate_loss
    from repro_torch.nn.modules import count_params
    from repro_torch.optim import init_adamw
    from repro_torch.train import make_train_step

    heads = cfg.flare_heads
    if mixer == "flare":
        model = get_model(cfg)
        if model.plans["train"].backend != "packed":
            raise AssertionError(f"flare train plan {model.plans['train'].describe()}")
        net, loss_fn, policy = model.init(SEED), model.loss, model.plans["infer"]
        ops = mixer_operands(net, batch["x"])
        b, h, n, d = ops[1].shape
        dy = torch.randn(b, n, h, d, generator=torch.Generator().manual_seed(SEED + 7))
        check_main(checks, "pde_16k", *ops)
        check_bwd_main(checks, "pde_16k", *ops, dy.to(device).transpose(1, 2))
        del ops, dy
        torch.cuda.empty_cache()
    else:
        net, policy = baseline_net(cfg, mixer, device), None
        loss_fn = lambda m, b: surrogate_loss(m, b, mixer=mixer, num_heads=heads)
    step = make_train_step(loss_fn, TrainConfig(steps=TABLE1["steps"], seed=SEED))
    opt = init_adamw(dict(net.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, ms = [], []
    for _ in range(TABLE1["steps"]):
        t0 = time.perf_counter()
        _, opt, met = step(net, opt, batch)
        losses.append(float(met["loss"]))   # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: surrogate_forward(net, batch["x"], mixer=mixer, num_heads=heads,
                                                   policy=policy), reps=3)
    row = dict(ms=statistics.median(ms[1:]), fwd_ms=fwd_ms, peak=peak, params=count_params(net),
               losses=losses, counts={k: n for k, n in counts.items() if n})
    print(f"table1 {mixer} pde_16k B={TABLE1['b']} N={batch['x'].shape[1]}: "
          f"{row['ms']:.3f} ms/step (median of steps 2-{TABLE1['steps']}; "
          f"{[round(t, 3) for t in ms]}), {fwd_ms:.3f} ms/forward, peak {peak:.2f} GiB, "
          f"{row['params']:,} parameters, losses {[round(x, 6) for x in losses]}, "
          f"launches {row['counts']}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"table1 {mixer}: non-finite loss {losses}")
    if mixer == "flare":
        per_run = TABLE1["steps"] * cfg.num_layers
        if not counts["flare_fused_fwd"] == counts["flare_fused_bwd"] == per_run:
            raise AssertionError(f"table1 flare launches {counts}")
        return row
    if row["counts"]:
        raise AssertionError(f"table1 {mixer}: a port kernel launched: {row['counts']}")
    seen = breakdown(lambda: step(net, opt, batch), f"table1 {mixer} step", top=6)
    assert_route(seen, f"table1 {mixer} step", MEM_EFF,
                 refuse=() if mixer == "transolver" else SOFTMAX)
    ops = aten_ops(lambda: step(net, opt, batch))
    calls = attention_calls(cfg, mixer)
    got = {op: n for op, n in ops.items() if "attention" in op}
    print(f"  {mixer}: attention ops a step {got}", flush=True)
    if got != {op: calls for op in MEM_EFF_OPS}:
        raise AssertionError(f"table1 {mixer}: {got} in a step, not the memory-efficient op "
                             f"once each way for each of its {calls} attention calls")
    # the math route would hold one block's [B, H, S, T] fp32 scores and their
    # softmax at once (the Transolver's slice scores are small beside its
    # slice weights, so its peak shows nothing of the route)
    b, n, s = TABLE1["b"], batch["x"].shape[1], cfg.flare_latents
    scores = {"vanilla": n * n, "perceiver": s * n, "linformer": n * s,
              "transolver": s * s}[mixer] * b * heads * 4 / 2**30
    print(f"  {mixer}: {calls} memory-efficient attention calls a step each way; one block's "
          f"fp32 scores would be {scores:.2f} GiB, the step's peak {peak:.2f} GiB", flush=True)
    if mixer != "transolver" and not peak < 2 * scores:
        raise AssertionError(f"table1 {mixer}: peak {peak:.2f} GiB is not below one block's "
                             f"materialised scores and softmax ({2 * scores:.2f} GiB)")
    return row


def fig8_sweep(cfg, device) -> dict:
    """One block's forward (the Perceiver: encode, one latent block, decode)
    under no_grad at B=1 over FIG8_N, by CUDA events, each beside FLARE's
    block (the ``packed`` plan) at the same N."""
    import torch

    from repro_torch.core.flare import flare_block, init_flare_block
    from repro_torch.models import pde
    from repro_torch.models.api import get_model

    c, h, m = cfg.d_model, cfg.flare_heads, cfg.flare_latents
    plan = get_model(cfg).plans["infer"]
    gen = torch.Generator().manual_seed(SEED + 5)
    kw = dict(generator=gen, device=device)
    gen_x = torch.Generator(device=device).manual_seed(SEED + 6)   # inputs drawn on the card
    blocks = {"flare": init_flare_block(c, h, m, **kw),
              "vanilla": pde.init_vanilla_block(c, h, **kw),
              "perceiver": pde.init_perceiver(c, h, m, 1, **kw),
              "linformer": pde.init_linformer_block(c, h, m, **kw),
              "transolver": pde.init_transolver_block(c, h, m, **kw)}
    run = {"flare": lambda x: flare_block(blocks["flare"], x, policy=plan),
           "vanilla": lambda x: pde.vanilla_block(blocks["vanilla"], x, h),
           "perceiver": lambda x: pde.perceiver_forward(blocks["perceiver"], x, h),
           "linformer": lambda x: pde.linformer_block(blocks["linformer"], x, h),
           "transolver": lambda x: pde.transolver_block(blocks["transolver"], x, h)}
    times = {}
    for n in FIG8_N:
        x = torch.randn(1, n, c, generator=gen_x, device=device)
        row = {}
        for mixer in ("flare",) + BASELINES:
            if mixer == "linformer" and n > pde.MAX_TOKENS:
                row[mixer] = f"skipped: N > {pde.MAX_TOKENS}"
            elif mixer == "vanilla" and n > VANILLA_MAX_N:
                row[mixer] = "skipped: N²"
            else:
                with torch.no_grad():
                    row[mixer] = cuda_ms(lambda: run[mixer](x), reps=2 if n > 1e5 else 5)
            times[mixer, n] = row[mixer]
        flare = row["flare"]
        print(f"fig8 N={n}: flare {flare:.3f} ms | " + " | ".join(
            f"{k} {v:.3f} ms ({v / flare:.2f}x flare)" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "flare"), flush=True)
        del x
        torch.cuda.empty_cache()
    return times


def pde_baselines(checks: Checks, cfg, device) -> dict:
    """The Table-1 phase: each baseline held against the fp64 plain oracle,
    the fig. 8 sweep, the five mixers trained at pde_16k. Returns the FLARE
    row's counted launches (the fused forward and backward)."""
    import torch

    from repro_torch.data.pde_data import darcy_batch

    t0 = time.perf_counter()
    failures = []
    for mixer in BASELINES:
        failures += check_baseline(cfg, mixer, device)
        torch.cuda.empty_cache()
    fig8_sweep(cfg, device)
    batch = darcy_batch(SEED, 0, TABLE1["b"], grid=TABLE1["grid"])
    rows = {}
    for mixer in ("flare",) + BASELINES:
        rows[mixer] = table1_row(checks, cfg, mixer, batch, device)
        torch.cuda.empty_cache()
    print(f"pde baselines phase: {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        raise AssertionError("pde baselines: " + "; ".join(failures))
    return rows["flare"]["counts"]


def spectral_phase(net, x) -> dict:
    """``spectrum_by_head`` (``core/spectral.py``, Algorithm 1) on the card at
    flare_pde's width: block 0's latent queries [H, M, D] and the first
    example's keys [H, N, D] for input ``x``, in fp32 against the same
    function in fp64 on the card: max |eigval fp32 - fp64| within
    SPECTRAL_TOL of the largest eigenvalue, which the fp64 spectrum of the
    keys without their last SPECTRAL_DROP tokens must fail. Prints each
    head's effective rank (0.99 of the energy) and the seconds. Returns the
    fp32 call's seconds and the ranks."""
    import torch

    from repro_torch.core.spectral import effective_rank, spectrum_by_head

    t_phase = time.perf_counter()
    q, k, _ = mixer_operands(net, x[:1])
    k = k[0]   # [H, N, D]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals = spectrum_by_head(q, k)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    want = spectrum_by_head(q.double(), k.double())
    drop = spectrum_by_head(q.double(), k[:, :-SPECTRAL_DROP].double())
    scale = want.abs().max().item()
    rel, rel_drop = max_err(vals, want) / scale, max_err(drop, want) / scale
    ranks = [int(effective_rank(v)) for v in want]
    h, m, d = q.shape
    print(f"spectral flare_pde block 0 pde_40k (H={h}, M={m}, N={k.shape[1]}, D={d}): "
          f"max eigval {scale:.6g}, fp32 vs fp64 rel {rel:.3g} (limit {SPECTRAL_TOL:g}), the keys' "
          f"last {SPECTRAL_DROP} tokens dropped: rel {rel_drop:.3g}; effective ranks (0.99) "
          f"{ranks} of {m}; fp32 {fp32_s:.3f} s; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not (math.isfinite(rel) and rel <= SPECTRAL_TOL < rel_drop):
        raise AssertionError(f"spectral: rel {rel:.3g}, dropped tokens rel {rel_drop:.3g}, "
                             f"limit {SPECTRAL_TOL}")
    return {"fp32_s": fp32_s, "effective_ranks": ranks}


def drive(model, net, batches: dict, label: str) -> dict:
    """One counted window: launch counts zeroed just before, read just after."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    outs = {}
    for shape, (batch, reps) in batches.items():
        out, ms, peak = forward_ms(model, net, batch, reps)
        rel = check_output(f"{label} {shape}", out, batch)
        outs[shape] = out
        b, n = batch["x"].shape[:2]
        print(f"path {label} {shape} B={b} N={n}: {ms:.3f} ms/forward, peak {peak:.2f} GiB, "
              f"rel-L2 vs target {rel:.4f}", flush=True)
    counts = launch_counts()
    print(f"path {label} launches: {counts}", flush=True)
    return {"counts": counts, "outs": outs}


# --------------------------------------------------------------------------
# MLA served from the paged pool: DeepSeek-V2-Lite (MLA + MoE) and MiniCPM3-4B
# --------------------------------------------------------------------------


def init_mla_lm(arch: str, params: tuple):
    """``get_model(arch)`` at full width and depth, its weights drawn on the
    card from a CUDA generator seeded with SEED (the CPU would take minutes
    for DeepSeek's 15.7B): (cfg, model, net); raises unless the parameter
    count lies in ``params`` (tests/test_models_smoke.py's range)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    model = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model.init(SEED, generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    m = cfg.attn.mla
    moe = (f", {cfg.moe.num_experts} routed experts top-{cfg.moe.top_k} + {cfg.moe.num_shared} "
           f"shared, {cfg.moe.first_dense_layers} dense layer(s)" if cfg.moe else "")
    print(f"init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.attn.num_heads} MLA heads (kv_lora {m.kv_lora_rank}, q_lora {m.q_lora_rank}, "
          f"rope {m.qk_rope_head_dim}){moe}, vocab {cfg.vocab}: {n_params} parameters "
          f"({n_params * 4 / 2**30:.2f} GiB fp32) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not params[0] <= n_params <= params[1]:
        raise AssertionError(f"{cfg.name}: {n_params} parameters outside {params}")
    return cfg, model, net


def mla_operands(g: int, d: int, d2: int, page_dtype: str, scale: float, device, gen) -> dict:
    """Random operands of MLA's paged read at (G, D, D2): fp32 q [B, 1, G, D]
    and q2, one page head of latents [NB, 16, 1, D] (both K and V: one
    tensor) and rotary keys [NB, 16, 1, D2] in ``page_dtype`` (int8 / fp8
    quantized with per-row scales), a shuffled page table whose unmapped
    entries point at a trash row of NaN, lanes of MLA_LENGTHS tokens."""
    import torch

    from repro_torch.serve.pool.quant import get_quant, quantize

    b, block = len(MLA_LENGTHS), 16
    pages = -(-max(MLA_LENGTHS) // block)
    nb = b * pages + 1
    lengths = torch.tensor(MLA_LENGTHS, dtype=torch.int32)
    pt = torch.randperm(nb - 1, generator=gen)[: b * pages].reshape(b, pages).int()
    for i in range(b):
        pt[i, -(-int(lengths[i]) // block):] = nb - 1
    op = {"q": torch.randn(b, 1, g, d, generator=gen) * d ** -0.5,
          "q2": torch.randn(b, 1, g, d2, generator=gen) * d2 ** -0.5,
          "page_table": pt, "lengths": lengths}
    c = torch.randn(nb, block, 1, d, generator=gen)
    kr = torch.randn(nb, block, 1, d2, generator=gen)
    if page_dtype in ("int8", "fp8"):
        spec = get_quant(page_dtype)
        (c, cs), (kr, krs) = quantize(spec, c), quantize(spec, kr)
        op.update(k_scale=cs, v_scale=cs, k2_scale=krs)
    else:
        c, kr = c.to(getattr(torch, page_dtype)), kr.to(getattr(torch, page_dtype))
    c[nb - 1] = torch.nan if c.is_floating_point() else 127
    op.update(k_pages=c, k2_pages=kr)
    op = {key: t.to(device) for key, t in op.items()}
    op.update(v_pages=op["k_pages"], scale=scale, out_dtype=torch.bfloat16, trash=nb - 1)
    return op


def requantize(op: dict, page_dtype: str) -> dict:
    """A captured MLA read's bf16 pages as a ``page_dtype`` pool would hold
    them: widened to fp32 (exact), or quantized to int8 / fp8 with per-row
    scales."""
    from repro_torch.serve.pool.quant import get_quant, quantize

    if page_dtype == "float32":
        c = op["k_pages"].float()
        return {**op, "k_pages": c, "v_pages": c, "k2_pages": op["k2_pages"].float()}
    spec = get_quant(page_dtype)
    (c, cs), (kr, krs) = quantize(spec, op["k_pages"].float()), quantize(spec,
                                                                        op["k2_pages"].float())
    return {**op, "k_pages": c, "v_pages": c, "k2_pages": kr, "k_scale": cs, "v_scale": cs,
            "k2_scale": krs}


def mla_call(op: dict):
    """(q, latents, page table, lengths, the call's keywords) of an MLA read."""
    if op["v_pages"] is not op["k_pages"]:
        raise AssertionError("the MLA read's V is not its K")
    kw = {key: op[key] for key in ("scale", "k_scale", "v_scale", "q2", "k2_pages", "k2_scale")
          if op.get(key) is not None}
    return op["q"], op["k_pages"], op["page_table"], op["lengths"], kw


def check_mla_read(checks: Checks, label: str, op: dict) -> None:
    """The paged kernel at MLA's read (K and V the same latents, q2 over the
    rotary key) against the plain version in fp64 at 1e-5 of max |plain|,
    fp32 out; the plain version with the first valid page of the longest
    lane left out must fail that limit; a lane of length 0 is exact zeros."""
    import torch

    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref as ref

    q, c, pt, lengths, kw = mla_call(op)
    trash = op.get("trash", int(pt[0, 0]))
    got = paged_attention(q, c, c, pt, lengths, out_dtype=torch.float32, **kw)
    if not torch.isfinite(got).all():   # say where, and whether a second call repeats it
        bad = (~torch.isfinite(got)).nonzero()
        again = paged_attention(q, c, c, pt, lengths, out_dtype=torch.float32, **kw)
        print(f"  {label}: {bad.shape[0]} non-finite outputs in lanes "
              f"{sorted(set(bad[:, 0].tolist()))}, rows {sorted(set(bad[:, 2].tolist()))[:8]}; "
              f"a second call: {int((~torch.isfinite(again)).sum())}; q finite: "
              f"{bool(torch.isfinite(q).all())}", flush=True)
    plain32 = ref(q, c, c, pt, lengths, out_dtype=torch.float32, **kw)
    wkw = wide_kw(kw)
    want = ref(q.double(), c, c, pt, lengths, out_dtype=torch.float64, **wkw)
    drop = ref(q.double(), c, c, *drop_page(pt, lengths, c.shape[1], trash),
               out_dtype=torch.float64, **wkw)
    checks.hold("paged_attention", label, got, want, torch.float32, atol=ATOL["float32"],
                record=True, dropped={"page": drop}, fp32_plain=plain32)
    empty = lengths == 0
    if empty.any() and got[empty].any():
        checks.failures.append(f"paged_attention {label}: a lane of length 0 is not exact 0")


def time_mla_read(label: str, op: dict) -> dict:
    """The kernel as the model calls it (replayed from a CUDA graph, which
    holds nothing but the kernel's own launches), the plain version and one
    SDPA over the gathered view (the G heads as G query rows of the one
    page head: q = [q_abs | q_rope], k = [c | k_rope], v = c; K and V
    broadcast over G heads instead made SDPA's memory-efficient kernel give
    outputs that differ run to run at MiniCPM3's shape, 12% off fp64, and
    fault in whole runs: ``scripts/torch_sdpa_yardstick.py``), both eager. With those two captured in
    graphs as well, the start of MiniCPM3's captured layer-0 q was found
    overwritten after the timings in two whole runs (other data, some of it
    NaN), and the reads checked after it failed; graph captures of cuBLAS
    calls, whose workspace a capture takes from its private pool, are the
    suspect. Every check of the phase now runs before any timing.
    Beside the bound: each valid page's rows and scales and q, q2, o once;
    2 G (2 D + D2) FLOP a valid token; its time is that of the fewest
    tensor-core products that give it exact to q, which beat the CUDA
    cores' 67 TFLOP/s: for fp32 pages three TF32 products each (q, the rows
    and P in two TF32 parts; two in S where q and q2 are bf16-valued, so one
    TF32 part holds them), at the TF32 peak; for the others S with q in
    three bf16 parts (one where q and q2 are bf16-valued) and P V with P in
    MLA_P_PARTS (one-byte rows widen to bf16 exactly), at the bf16 peak.
    Also the floors of the instance's design: the bytes alone, and its
    products as it issues them (G padded to m16 tiles; the fp32 instance
    splits q in every case, the others skip q's lower parts where it is
    bf16-valued), at that peak and, for fp32 pages, at
    ``mma.sync``'s measured TF32 rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import _gather_rows, paged_attention_ref as ref

    q, c, pt, lengths, kw = mla_call(op)
    b, h, g, d = q.shape
    block = c.shape[1]
    out_dtype = op.get("out_dtype") or torch.float32
    d2 = kw["q2"].shape[-1]
    n_pages = ((lengths.long() + block - 1) // block).clamp(max=pt.shape[1]).sum().item()
    row = (d + d2) * c.element_size() + (8 if "k_scale" in kw else 0)
    nbytes = (n_pages * block * row + (q.numel() + kw["q2"].numel()) * 4
              + q.numel() * torch.empty((), dtype=out_dtype).element_size())
    gp, tokens = -(-g // 16) * 16, lengths.long().sum().item()   # m16 row tiles
    flops = 2 * g * (2 * d + d2) * h * tokens
    narrow = all(torch.equal(x, x.bfloat16().to(x.dtype)) for x in (q, kw["q2"]))
    if c.dtype == torch.float32:   # products a (token, head, column): bound's, design's
        parts, issued_parts = (2 if narrow else 3) * (d + d2) + 3 * d, 3 * (2 * d + d2)
        peak = PEAK_TF32
    else:
        parts = issued_parts = (1 if narrow else 3) * (d + d2) + MLA_P_PARTS * d
        peak = PEAK_BF16
    t_ops, t_bytes = 2 * g * h * tokens * parts / peak * 1e3, nbytes / PEAK_BW * 1e3
    kernel = lambda: paged_attention(q, c, c, pt, lengths, out_dtype=out_dtype, **kw)
    plain = lambda: ref(q, c, c, pt, lengths, out_dtype=out_dtype, **kw)
    stats = dict(ms=graph_ms(kernel, reps=50), plain_ms=cuda_ms(plain, reps=10),
                 bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                 else "bytes", library_ms=None)
    issued = 2 * gp * h * tokens * issued_parts
    stats.update(floor_bytes_ms=t_bytes, floor_products_ms=issued / peak * 1e3)
    if c.dtype == torch.float32:
        stats["floor_products_mma_sync_ms"] = issued / MMA_SYNC_TF32 * 1e3
    if c.dtype in (torch.bfloat16, torch.float32):
        # the yardstick over the dense view gathered beforehand (not timed)
        cd, krd = _gather_rows(c, pt), _gather_rows(kw["k2_pages"], pt)   # [B, 1, T, *]
        t = cd.shape[2]
        qd = torch.cat([q, kw["q2"]], dim=-1).to(c.dtype)                   # [B, 1, G, D+D2]
        kd = torch.cat([cd, krd], dim=-1)
        mask = (torch.arange(t, device=q.device)[None, :]
                < lengths.long()[:, None])[:, None, None, :].expand(b, 1, g, t).contiguous()
        stats["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, cd, attn_mask=mask, scale=kw.get("scale", 1.0)), reps=50)
    print(f"time paged_attention {label}: {stats} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} "
          f"GFLOP over {lengths.long().sum().item()} tokens)", flush=True)
    return stats


def mla_kernel_phase(checks: Checks, cfg, model, net, reqs, device) -> dict:
    """(a) the MLA read on random operands at cfg's shape, fp32 q over bf16,
    int8, fp8 and fp32 pages; (b) the same checks on layer 0's own decode
    operands after a real prefill (captured from the wrapper's first call in
    an uncounted engine step; int8 / fp8 by quantizing its bf16 pages, fp32
    by widening them); then
    the times of the random case at every page dtype and of layer 0's bf16
    read, after every check. Returns the bf16 random case's times (the JSON
    line's MLA read, ``paged_mla_tc_kernel``) with the fp32 random case's
    under ``fp32_pages`` (``paged_mla_tf32_kernel``)."""
    import torch

    m = cfg.attn.mla
    g, d, d2 = cfg.attn.num_heads, m.kv_lora_rank, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    gen = torch.Generator().manual_seed(SEED + 23)
    print(f"kernels paged MLA read {cfg.name} (G={g}, D={d}, D2={d2}, one page head, the "
          f"latents both K and V; lanes of {list(MLA_LENGTHS)} tokens, blocks of 16, unmapped "
          f"pages at a NaN trash row; scale {scale:.5g}; held against the plain version in "
          "fp64):", flush=True)
    ops = {page_dtype: mla_operands(g, d, d2, page_dtype, scale, device, gen)
           for page_dtype in MLA_PAGE_DTYPES}
    for page_dtype, op in ops.items():
        check_mla_read(checks, f"{cfg.name} random {page_dtype}", op)
    captured = capture_decode_read(model, net, reqs, SERVE)
    if captured["q"].shape[1:] != (1, g, d):
        raise AssertionError(f"captured read q {tuple(captured['q'].shape)}")
    check_mla_read(checks, f"{cfg.name} layer 0 bf16", captured)
    for page_dtype in ("int8", "fp8", "float32"):
        check_mla_read(checks, f"{cfg.name} layer 0 {page_dtype}",
                       requantize(captured, page_dtype))
    checks.raise_failures(f"MLA read {cfg.name}")
    times = {page_dtype: time_mla_read(f"{cfg.name} random {page_dtype}", op)
             for page_dtype, op in ops.items()}
    time_mla_read(f"{cfg.name} layer 0 bf16", captured)
    del captured, ops
    torch.cuda.empty_cache()
    return {"kernel": "paged_mla_tc_kernel", **times["bfloat16"],
            "fp32_pages": {"kernel": "paged_mla_tf32_kernel", **times["float32"]}}


def mla_scopes(model, net, reqs) -> dict:
    """One eager kernel-route decode step with every slot busy (the first
    ``SERVE["slots"]`` prompts cut to 256 tokens): its ``obs.scope`` counts
    (one ``kernels.paged_attention`` a layer), then the next step's profiler
    breakdown (the device's busy share, the paged kernel's share of it);
    then the same prompts on the graph route and one replayed step's
    breakdown (``route`` line: the tensor-core MLA instance)."""
    import gc

    from repro_torch.serve.engine import ServeEngine

    name = model.cfg.name
    for graph in (False, True):
        engine = ServeEngine(model, net, **SERVE, decode_backend="paged", cuda_graph=graph)
        if graph:
            engine.warmup(max_prompt_len=256)
        for prompt, _ in reqs[:SERVE["slots"]]:
            engine.submit(prompt[:256], max_new_tokens=8)
        while engine.sched.waiting or not engine.sched.running:
            engine.step()
        if not graph:
            counts = scope_counts(engine.step, ("kernels.paged_attention", "serve.decode"))
        kind = "replayed" if graph else "eager"
        prof = breakdown(engine.step, f"serve {name} bf16 paged {kind} decode step "
                         f"({len(engine.sched.running)} slots busy)")
        assert_route(prof, f"serve {name} bf16 paged {kind} decode step",
                     ("paged_mla_tc_kernel",), refuse=("paged_mla_tf32_kernel",))
        dev = sum(prof[0].values())
        kern = sum(ms for key, ms in prof[0].items() if "paged_" in key)
        print(f"  decode step ({kind}): device busy {100 * dev / prof[1]:.1f}% of "
              f"{prof[1]:.3f} ms wall, paged kernel {kern:.3f} ms = {100 * kern / dev:.1f}% of "
              "device time", flush=True)
        del engine
        gc.collect()
    return counts


def expert_cast_cost(cfg, net) -> None:
    """The MoE layers' per-call cast of the stacked expert weights to bf16
    (the JAX package's ``astype`` in ``moe_ffn``): its ms a layer and a
    decode step, beside one MoE FFN at the decode shape (8 slots)."""
    import torch

    from repro_torch.models.moe import moe_ffn

    mlp = net.layers[0].mlp
    weights = (mlp.w_gate, mlp.w_up, mlp.w_down)
    nbytes = sum(w.numel() for w in weights) * (4 + 2)
    cast = cuda_ms(lambda: [w.to(torch.bfloat16) for w in weights], reps=5)
    x = torch.randn(SERVE["slots"], 1, cfg.d_model, device=mlp.w_up.device,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        ffn = cuda_ms(lambda: moe_ffn(mlp, x, cfg.moe), reps=5)
    layers = len(net.layers)
    print(f"moe {cfg.name}: the expert weights' cast to bf16 {cast:.3f} ms a layer "
          f"({nbytes / 1e9:.2f} GB read and written; {nbytes / PEAK_BW * 1e3:.3f} ms at "
          f"{PEAK_BW / 1e12:g} TB/s), "
          f"x{layers} = {cast * layers:.2f} ms a decode step; moe_ffn at B={SERVE['slots']}, S=1: "
          f"{ffn:.3f} ms a layer, x{layers} = {ffn * layers:.2f} ms", flush=True)


def mla_serve(cfg, model, net, reqs) -> dict:
    """The engine over ``reqs`` on the dense pool and the paged pool's kernel
    route in bf16, then MLA_SERVE32 requests in fp32 compute on the dense
    pool, the gather route and the kernel route, whose greedy tokens must
    be equal; the fp32 kernel route's reads (fp32 q over the pool's bf16
    latents) must all run the tensor-core instance (its launches by route,
    and the kernel names in one profiled decode step). Returns the bf16 kernel route's run (its launches are the
    main path's)."""
    import torch

    from repro_torch.config import replace
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.api import get_model

    # bf16 on the dense pool and the kernel route (the gather route, whose
    # bf16 reading would only be printed, runs in fp32 below, where its tokens
    # are held: a depth cut for the script's time limit), by graph replay;
    # the kernel route's eager oracle decodes EAGER_NEW tokens a request
    runs = {name: serve_run(model, net, reqs, f"bf16 {name}", **ROUTES[name])
            for name in ("dense", "paged")}
    div = first_divergence(runs["paged"]["tokens"], runs["dense"]["tokens"])
    print(f"serve {cfg.name} bf16 paged vs dense: greedy tokens "
          + ("all equal" if div is None else f"first differ at request {div[0]}, token "
             f"{div[1]}"), flush=True)
    graph_held(f"{cfg.name} bf16 paged", runs["paged"],
               serve_run(model, net, [(p, EAGER_NEW) for p, _ in reqs], "bf16 paged",
                         graph=False, **ROUTES["paged"]), "bfloat16")
    model32 = get_model(replace(cfg, compute_dtype="float32"))
    reqs32 = serve_requests(cfg.vocab, MLA_SERVE32_REQUESTS, (MLA_SERVE32_NEW, MLA_SERVE32_NEW),
                            longest_first=False, lens=PROMPT_LENS)
    runs32 = {}
    for name, kw in ROUTES.items():
        runs32[name] = serve_run(model32, net, reqs32, f"fp32 {name}",
                                 profile=name == "paged", **kw)
        if name == "paged":   # launch counts are zeroed at the start of each run
            by_route = dict(paged_attention.launches_by_route)
    label = f"serve {cfg.name} fp32 paged decode step"
    assert_route(runs32["paged"]["prof"] or None, label, ("paged_mla_tc_kernel",),
                 refuse=("paged_mla_tf32_kernel",))
    if (by_route["mla_tc"] != runs32["paged"]["counts"]["paged_attention"]
            or by_route["mla_tf32"]):
        raise AssertionError(f"{label}: paged launches by route {by_route}, expected all on "
                             "the tensor-core MLA instance")
    for name, kw in ROUTES.items():
        graph_held(f"{cfg.name} fp32 {name}", runs32[name],
                   serve_run(model32, net, reqs32, f"fp32 {name}", graph=False, **kw), "float32")
    for name in ("gather", "paged"):
        first_step_held(f"{cfg.name} fp32 {name}", runs32[name], runs32["dense"],
                        ROUTE_TOL["float32"])
        div = first_divergence(runs32[name]["tokens"], runs32["dense"]["tokens"])
        if div is not None:
            raise AssertionError(f"{cfg.name} fp32 {name}: greedy tokens differ from the dense "
                                 f"pool's at request {div[0]}, token {div[1]}")
    print(f"serve {cfg.name} fp32: the greedy tokens of all {MLA_SERVE32_REQUESTS} x "
          f"{MLA_SERVE32_NEW} positions are equal across the dense, gather and kernel routes, "
          "graph and eager", flush=True)
    del runs32, model32
    torch.cuda.empty_cache()
    return runs["paged"]


def mla_prefix(cfg, model, net) -> int:
    """MiniCPM3 served with the prefix cache in bf16 (the kernel route): a
    pinned MLA_PREFIX_TEMPLATE-token template and MLA_PREFIX_REQUESTS
    requests sharing it, the cache off and on; every hit's first-token
    logits against the cold run's within 5e-2 of max |logit|; a control,
    one hit's first shared page pointed at another live block, must exceed
    it. Returns the cache-on run's paged launches."""
    template, prompts = prefix_workload(cfg.vocab, MLA_PREFIX_TEMPLATE, MLA_PREFIX_REQUESTS)
    print(f"serve prefix {cfg.name}: a {len(template)}-token template, {len(prompts)} prompts of "
          f"{[len(p) for p in prompts]} tokens, {MLA_PREFIX_NEW} new tokens each", flush=True)
    off = prefix_run(model, net, template, prompts, f"{cfg.name} bf16 cache off", cache=False,
                     new=MLA_PREFIX_NEW)
    on = prefix_run(model, net, template, prompts, f"{cfg.name} bf16 cache on", cache=True,
                    new=MLA_PREFIX_NEW)
    div = first_divergence(on["tokens"], off["tokens"])
    print(f"serve prefix {cfg.name} bf16 on vs off: greedy tokens "
          + ("all equal" if div is None else f"first differ at request {div[0]}, token {div[1]}"),
          flush=True)
    graph_held(f"prefix {cfg.name} bf16 cache on", on,
               prefix_run(model, net, template, prompts, f"{cfg.name} bf16 cache on", cache=True,
                          new=MLA_PREFIX_NEW, graph=False), "bfloat16")
    sound = first_logits_rel(f"{cfg.name} bf16 hits vs cold",
                             [(on["first"][i], off["first"][i]) for i in on["hits"]],
                             ROUTE_TOL["bfloat16"])

    def corrupt(engine, req, slot):
        other = engine._pins[len(engine._pins) // 2]
        lease = engine._leases[slot]
        engine.alloc.acquire(other)
        engine.alloc.release_ref(lease.mapped[0])
        lease.mapped[0] = engine._pt[slot, 0] = other

    ctrl = prefix_run(model, net, template, prompts[1:2], f"{cfg.name} bf16 control",
                      cache=True, new=1, corrupt=corrupt)
    control = first_logits_rel(f"{cfg.name} control (request 1, page 0 -> a pinned middle "
                               "block) vs cold", [(ctrl["first"][0], off["first"][1])],
                               ROUTE_TOL["bfloat16"])
    failures = []
    if not (on["hits"] and sound <= ROUTE_TOL["bfloat16"]):
        failures.append(f"hits {on['hits']}, first-token logits rel {sound:.4g}")
    if not control > ROUTE_TOL["bfloat16"]:
        failures.append(f"the limit passes a corrupted shared page (rel {control:.4g})")
    if failures:
        raise AssertionError(f"serve prefix {cfg.name}: " + "; ".join(failures))
    return on["counts"]["paged_attention"]


def mla_phase(checks: Checks, arch: str, params: tuple, device) -> dict:
    """One MLA model at full width and depth: its weights drawn on the card,
    the MLA read held and timed (random and layer 0's operands), requests
    served on the dense and kernel routes in bf16 and on the three routes in
    fp32, one kernel-route decode step's scopes (a
    ``kernels.paged_attention`` a layer) and breakdown, MoE: the expert
    casts' cost; MiniCPM3: the prefix cache. Returns the MLA read's times
    with the phase's kernel-route launches."""
    import gc

    import torch

    t_phase = time.perf_counter()
    # the engines of earlier phases hold their model in reference cycles
    # (their scheduler's callbacks): collect them before a 58.5 GiB draw
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, net = init_mla_lm(arch, params)
    reqs = serve_requests(cfg.vocab, SERVE_REQUESTS, (MLA_NEW, MLA_NEW), longest_first=True,
                          lens=PROMPT_LENS)
    print(f"requests: {len(reqs)} prompts of {[len(p) for p, _ in reqs]} tokens, {MLA_NEW} new "
          f"tokens each; engine {SERVE}", flush=True)
    stats = mla_kernel_phase(checks, cfg, model, net, reqs, device)
    paged = mla_serve(cfg, model, net, reqs)
    stats["launches"] = paged["counts"]["paged_attention"]
    stats["serve"] = {key: paged[key] for key in ("step_ms", "tok_s", "prefill_ms", "peak_gib")}
    scopes = mla_scopes(model, net, reqs)
    print(f"serve {cfg.name} scopes of one kernel-route decode step: {scopes} (want "
          f"{cfg.num_layers} kernels.paged_attention)", flush=True)
    if scopes["kernels.paged_attention"] != cfg.num_layers or scopes["serve.decode"] != 1:
        raise AssertionError(f"{cfg.name}: decode step scopes {scopes}")
    if cfg.moe is not None:
        expert_cast_cost(cfg, net)
    else:
        stats["launches"] += mla_prefix(cfg, model, net)
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {cfg.name} phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return stats


def init_recurrent(arch: str, size: tuple):
    """``get_model(arch)`` at full width and depth, its weights drawn on the
    card from a CUDA generator seeded with SEED: (cfg, model, net); raises
    unless (layers, parameters) is ``size``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = get_config(arch)
    model = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = model.init(SEED, generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    m = cfg.ssm
    shape = (f"{cfg.d_model // m.head_dim} heads of {m.head_dim}" if m.kind == "rwkv6" else
             f"Mamba2 d_inner {m.expand * cfg.d_model}, state {m.state_dim}, a shared block "
             f"every {cfg.shared_attn_every} layers ({cfg.attn.num_heads} heads / "
             f"{cfg.attn.num_kv_heads} KV heads x {cfg.attn.head_dim}, LoRA {cfg.lora_rank})")
    print(f"init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, vocab "
          f"{cfg.vocab}: {n_params} parameters ({n_params * 4 / 2**30:.2f} GiB fp32) drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s", flush=True)
    if (cfg.num_layers, n_params) != size:
        raise AssertionError(f"{cfg.name} is not at full size: {cfg.num_layers} layers, "
                             f"{n_params} parameters")
    return cfg, model, net


def recurrent_requests(vocab: int):
    reqs = serve_requests(vocab, RECURRENT_REQUESTS, (RECURRENT_NEW, RECURRENT_NEW),
                          longest_first=True, lens=RECURRENT_PROMPTS)
    print(f"requests: {len(reqs)} prompts of {[len(p) for p, _ in reqs]} tokens, "
          f"{RECURRENT_NEW} new tokens each; engine {SERVE}", flush=True)
    return reqs


def rel_err(got, want) -> float:
    return max_err(got, want) / want.abs().max().item()


def check_wkv(cfg, net, device) -> None:
    """Layer 0's chunked WKV (the prefill's form, fp32) on the WKV operands
    the model gives it for a WKV_T-token prompt (bf16 compute), against the
    scan on the same values in fp64: y and the final state within WKV_TOL of
    their largest value; the chunked form run a chunk at a time from a zero
    state (the inter-chunk term dropped) must fail the limit."""
    import torch

    from repro_torch.models import ssm

    chunk = cfg.ssm.chunk
    r, k, v, w, u = wkv_operands(cfg, net, dense_tokens(cfg.vocab, 1, WKV_T, SEED + 3, device))
    with torch.no_grad():
        y, s = ssm.rwkv6_wkv_chunked(r, k, v, w, u, chunk=chunk)
        wide = [t.double() for t in (r, k, v, w, u)]
        y64, s64 = ssm.rwkv6_wkv_scan(*wide)
        cut = [t.reshape(WKV_T // chunk, chunk, *t.shape[2:]) for t in wide[:4]]
        y_drop = ssm.rwkv6_wkv_chunked(*cut, wide[4], chunk=chunk)[0].reshape(y64.shape)
        ms = cuda_ms(lambda: ssm.rwkv6_wkv_chunked(r, k, v, w, u, chunk=chunk), reps=3)
        scan_ms = cuda_ms(lambda: ssm.rwkv6_wkv_scan(r, k, v, w, u), reps=1)
    errs = {"y": rel_err(y, y64), "state": rel_err(s, s64), "y inter-chunk dropped":
            rel_err(y_drop, y64)}
    print(f"wkv rwkv6-3b layer 0 T={WKV_T} (H={r.shape[2]} D={r.shape[3]}, chunk {chunk}, "
          f"factored) fp32 chunked vs fp64 scan, over max |ref| (max |y| "
          f"{y64.abs().max().item():.4g}): " + ", ".join(f"{k_} rel {e:.3g}" for k_, e in
                                                       errs.items())
          + f" (limit {WKV_TOL:g}); chunked {ms:.3f} ms, fp32 scan {scan_ms:.3f} ms", flush=True)
    if not (errs["y"] <= WKV_TOL and errs["state"] <= WKV_TOL):
        raise AssertionError(f"rwkv6 chunked WKV off the fp64 scan: {errs}")
    if not errs["y inter-chunk dropped"] > WKV_TOL:
        raise AssertionError(f"the WKV limit {WKV_TOL} would pass a chunked form without its "
                             f"inter-chunk term ({errs})")


def recurrent_summary(name: str, graph: dict, eager: dict, t_phase: float) -> dict:
    """The family's serving line: decode ms a step on the graph and eager
    routes, tokens/s, peak GiB and the phase's seconds so far."""
    out = {key: graph[key] for key in ("step_ms", "tok_s", "prefill_ms", "peak_gib")}
    out["eager_step_ms"] = eager["step_ms"]
    print(f"serve {name}: decode {graph['step_ms']:.3f} ms/step graph, {eager['step_ms']:.3f} "
          f"ms/step eager; {graph['tok_s']:.1f} tok/s; prefill {graph['prefill_ms']:.2f} "
          f"ms/request; peak {graph['peak_gib']:.2f} GiB; {time.perf_counter() - t_phase:.1f} s "
          "into the phase", flush=True)
    return out


def rwkv_phase(checks: Checks, device) -> dict:
    """RWKV-6 3B at full width and depth, its weights drawn on the card: one
    layer's chunked WKV against the scan in fp64; the requests served on the
    dense pool in bf16 compute by graph replay, and on the eager step as its
    oracle (the same greedy tokens). No kernel: the state has no token axis,
    and the scans are plain torch. Returns the serving numbers."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, net = init_recurrent("rwkv6_3b", RWKV_SIZE)
    check_wkv(cfg, net, device)
    reqs = recurrent_requests(cfg.vocab)
    graph = serve_run(model, net, reqs, "bf16 dense", profile=True, **ROUTES["dense"])
    eager = serve_run(model, net, reqs, "bf16 dense", profile=True, graph=False,
                      **ROUTES["dense"])
    graph_held("rwkv6-3b bf16 dense", graph, eager, "bfloat16")
    div = first_divergence(graph["tokens"], eager["tokens"])
    if div is not None:
        raise AssertionError(f"rwkv6-3b: the graph route's greedy tokens differ from the eager "
                             f"step's at request {div[0]}, token {div[1]}")
    out = recurrent_summary(cfg.name, graph, eager, t_phase)
    del model, net, graph, eager
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {cfg.name} phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def zamba_attention_operands(net, cfg, tokens):
    """The shared block's first invocation's rope'd q [B, H, T, D] and k, v
    [B, Hkv, T, D] for ``tokens`` in the compute dtype: what
    ``zamba._shared_block`` gives ``attn_sdpa`` on the pallas route."""
    import torch

    from repro_torch.models import attention, rope, ssm, transformer, zamba
    from repro_torch.nn.modules import dense, embedding

    a = cfg.attn
    sh = net.shared
    with torch.no_grad():
        x0 = embedding(net.embed, tokens, getattr(torch, cfg.compute_dtype))
        x = x0
        for layer in net.mamba_groups[0]:
            x, _ = ssm.mamba2_block(layer, x, cfg.ssm)
        hin = transformer._norm(cfg, sh.norm1, dense(sh.in_proj, torch.cat([x, x0], -1)))
        q, k, v = (attention._heads(zamba.lora_dense(base, lora, 0, hin), n)
                   for base, lora, n in ((sh.attn.wq, sh.lora_q, a.num_heads),
                                         (sh.attn.wk, sh.lora_k, a.num_kv_heads),
                                         (sh.attn.wv, sh.lora_v, a.num_kv_heads)))
        ang = rope.rope_angles(rope.text_positions(*tokens.shape, device=tokens.device),
                               a.head_dim, a.rope_theta)
        return rope.apply_rope(q, ang), rope.apply_rope(k, ang), v


def time_flash_at(label: str, ops16, scale: float, *, causal: bool = True) -> dict:
    """CUDA-event times of the flash kernels on ``ops16`` (causal or not):
    the tensor-core kernel on the bf16 operands and the fp32 route on them
    widened, each beside its bound (4 * D FLOP a kept pair over the bf16 or
    fp32 peak, or q, k, v and o once over 3.35 TB/s), its plain version (a
    head at a time) and SDPA."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    b, h, n, d = ops16[0].shape
    hkv, skv = ops16[1].shape[1], ops16[1].shape[2]
    kw = dict(scale=scale, causal=causal, window=None)
    flops = 4 * d * b * h * visible_pairs(n, skv, causal=causal, window=None)
    elems = b * d * (2 * h * n + 2 * hkv * skv)     # q and o, k and v, once each
    rows = {}
    for name, ops, peak in (("flash_attention_tc", ops16, PEAK_BF16),
                            ("flash_attention", [t.float() for t in ops16], PEAK_FP32)):
        t_ops, t_bytes = flops / peak * 1e3, elems * ops[0].element_size() / PEAK_BW * 1e3
        rows[name] = dict(
            ms=cuda_ms(lambda: flash_attention(*ops, **kw), reps=5),
            plain_ms=cuda_ms(lambda: flash_by_block(flash_attention_ref, *ops, **kw), reps=1),
            library_ms=sdpa_ms(*ops, scale, reps=5, causal=causal),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        lengths = f"T={n}" if skv == n else f"Sq={n} Skv={skv}"
        print(f"time {name} {label} (B={b} H={h} Hkv={hkv} {lengths} D={d}, "
              f"{ops[0].dtype}): {rows[name]}", flush=True)
    return rows


def zamba_prefill_window(net, cfg, tokens, impl: str, capture=None) -> dict:
    """One counted window: launch counts zeroed just before one
    ``zamba_prefill`` of ``tokens`` (capacity their length) and read just
    after; ms and peak GiB. Raises unless it launched one flash kernel a
    shared invocation (``pallas``), all on the route of the compute dtype
    (the tensor cores for bf16, the fp32 route for fp32), or none. With
    ``capture`` (a list), each flash call's (q, k, v, output) is appended
    to it (copies, outside the timed work's meaning: ms is then not kept)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.models.zamba import _plan, zamba_prefill

    kernel = ops.flash_kernel

    def capturing(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        capture.append(tuple(t.clone() for t in (q, k, v, out)))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if capture is not None:
        ops.flash_kernel = capturing
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            logits, _ = zamba_prefill(net, {"tokens": tokens}, cfg, tokens.shape[1], impl=impl)
        torch.cuda.synchronize()
    finally:
        ops.flash_kernel = kernel
    ms = (time.perf_counter() - t0) * 1e3
    counts, routes = ops.launch_counts(), dict(flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"path {cfg.name} prefill impl={impl} B={tokens.shape[0]} T={tokens.shape[1]} "
          f"{cfg.compute_dtype}: {ms:.3f} ms{' (capturing)' if capture is not None else ''}, "
          f"peak {peak:.2f} GiB; launches {counts}, flash routes {routes}", flush=True)
    want = _plan(cfg)[0] if impl == "pallas" else 0
    route = "tensor_core" if cfg.compute_dtype == "bfloat16" else "fp32"
    if counts["flash_attention"] != want or routes[route] != want or any(
            c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"{cfg.name} prefill impl={impl}: launches {counts}, routes "
                             f"{routes}; expected {want} on the {route} route")
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"{cfg.name} prefill impl={impl}: logits not finite")
    return {"logits": logits, "ms": ms, "peak": peak, "launches": routes[route]}


def hold_prefill_flash(checks: Checks, label: str, calls: list, scale: float) -> None:
    """Each flash launch of a bf16 prefill (its q, k, v and output, as
    captured) against ``attn_sdpa``'s chunked route in fp64 on the same
    bf16 values, beyond bf16's output rounding (``Checks.hold_rounded``);
    the fp64 plain version with the 64-key tile at T/2 left out must fail
    each."""
    import functools

    import torch

    from repro_torch.kernels.attention import KV_TILE
    from repro_torch.models.attention import _expand_kv, attn_sdpa

    for i, (q, k, v, out) in enumerate(calls):
        wide = [t.double() for t in (q, k, v)]
        groups = q.shape[1] // k.shape[1]
        kw = dict(scale=scale, causal=True, window=None)
        with torch.no_grad():
            want = attn_sdpa(wide[0], _expand_kv(wide[1], groups), _expand_kv(wide[2], groups),
                             impl="chunked", **kw)
            t0 = q.shape[2] // 2 // KV_TILE * KV_TILE
            drop = flash_by_block(functools.partial(flash_dropped, t0=t0), *wide,
                                  chunk=FLASH_QCHUNK, **kw)
        checks.hold_rounded("flash_attention_tc", f"{label} call {i} vs chunked fp64", out, want,
                            dropped={f"KV tile {t0}": drop})
        del wide, want, drop
    torch.cuda.empty_cache()


def zamba_phase(checks: Checks, device) -> dict:
    """Zamba2-7B at full width and depth, its weights drawn on the card. The
    flash kernels at D=112 on the first shared invocation's operands of a
    ZAMBA_PREFILL_T-token prompt (held and timed as phase 13's); that
    prompt through ``zamba_prefill(impl="pallas")`` (a counted window: one
    tensor-core launch a shared invocation, 13), each launch held against
    the chunked route in fp64 beyond bf16 rounding, and in fp32 compute
    (13 launches on the fp32 route) against the chunked route's logits;
    then in fp32 compute the paged kernel at D=112 on the first
    invocation's decode read, and the requests through the dense pool, the
    gather route and the kernel route by graph replay (13 paged launches a
    decode step asserted; "auto" must pick the kernel route), the greedy
    tokens equal, the kernel route's equal to its eager oracle's. Returns
    the two kernels' D=112 records with the counted windows' launches, and
    the serving numbers."""
    import gc

    import torch

    from repro_torch.config import replace
    from repro_torch.models.api import get_model
    from repro_torch.models.zamba import _plan
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, net = init_recurrent("zamba2_7b", ZAMBA_SIZE)
    invocations = _plan(cfg)[0]
    scale = cfg.attn.head_dim ** -0.5
    tokens = dense_tokens(cfg.vocab, 1, ZAMBA_PREFILL_T, SEED + 4, device)
    ops16 = zamba_attention_operands(net, cfg, tokens)
    check_flash_main(checks, "zamba2-7b shared invocation 0", ops16, scale)
    flash = time_flash_at("zamba2-7b shared invocation 0", ops16, scale)
    del ops16
    torch.cuda.empty_cache()
    # the bf16 prefill (the model's compute dtype): a counted window, then
    # its 13 launches again, captured and held against the chunked route
    run = zamba_prefill_window(net, cfg, tokens, "pallas")
    calls = []
    zamba_prefill_window(net, cfg, tokens, "pallas", capture=calls)
    hold_prefill_flash(checks, "zamba2-7b prefill pallas", calls, scale)
    del calls
    with torch.no_grad():
        from repro_torch.models.zamba import zamba_prefill

        assert_route(breakdown(lambda: zamba_prefill(net, {"tokens": tokens}, cfg,
                                                     ZAMBA_PREFILL_T, impl="pallas"),
                               f"zamba2-7b prefill pallas B=1 T={ZAMBA_PREFILL_T} bf16"),
                     "zamba2-7b prefill pallas bf16", ("flash_tc_kernel",),
                     refuse=("flash_bf16_kernel", "flash_tf32_kernel"))
    want = zamba_prefill_window(net, cfg, tokens, "chunked")["logits"]
    # not held: the random-weight network amplifies a difference about
    # 1,000x over its 13 groups (fp32: 5.6e-7 after the first invocation,
    # 7.6e-4 at the last layer), so one bf16 rounding of an attention
    # output moves the logits by their own size on any two routes
    print(f"zamba2-7b prefill pallas vs chunked bf16 (last-token logits, not held): rel "
          f"{rel_err(run['logits'], want):.3g}", flush=True)
    cfg32 = replace(cfg, compute_dtype="float32")
    run32 = zamba_prefill_window(net, cfg32, tokens, "pallas")
    held("zamba2-7b prefill pallas vs chunked fp32 (last-token logits)", run32["logits"],
         zamba_prefill_window(net, cfg32, tokens, "chunked")["logits"], LM_TOL["float32"])
    flash["flash_attention_tc"]["launches"] = run["launches"]
    flash["flash_attention"]["launches"] = run32["launches"]
    del run, run32, want, tokens
    torch.cuda.empty_cache()

    model32 = get_model(cfg32)
    reqs = recurrent_requests(cfg.vocab)
    auto = ServeEngine(model32, net, **SERVE).stats["decode_backend"]
    gc.collect()   # the engine, held in a cycle by its scheduler, and its pool
    torch.cuda.empty_cache()
    print(f"serve {cfg.name}: decode backend under \"auto\": {auto}", flush=True)
    if not auto.startswith("paged("):
        raise AssertionError(f"{cfg.name}: the paged pool is not kernel-eligible ({auto})")
    paged = check_paged_main(checks, "zamba2-7b decode read invocation 0",
                             capture_decode_read(model32, net, reqs, SERVE))
    runs = {name: serve_run(model32, net, reqs, f"fp32 {name}", profile=name == "paged",
                            paged_per_step=invocations, **kw)
            for name, kw in ROUTES.items()}
    if runs["paged"]["per_step"] != invocations:
        raise AssertionError(f"{cfg.name} kernel route: {runs['paged']['per_step']} paged "
                             f"launches a step, not {invocations}")
    for name in ("gather", "paged"):
        first_step_held(f"fp32 {name}", runs[name], runs["dense"], ROUTE_TOL["float32"])
        div = first_divergence(runs[name]["tokens"], runs["dense"]["tokens"])
        if div is not None:
            raise AssertionError(f"{cfg.name} fp32 {name}: greedy tokens differ from the dense "
                                 f"pool's at request {div[0]}, token {div[1]}")
    eager = serve_run(model32, net, reqs, "fp32 paged", graph=False, profile=True,
                      paged_per_step=invocations, **ROUTES["paged"])
    graph_held("zamba2-7b fp32 paged", runs["paged"], eager, "float32")
    print(f"serve {cfg.name} fp32: the greedy tokens of all {RECURRENT_REQUESTS} x "
          f"{RECURRENT_NEW} positions are equal on the dense pool, the gather route and the "
          "kernel route, graph and eager", flush=True)
    serve = recurrent_summary(cfg.name, runs["paged"], eager, t_phase)
    paged["launches"] = runs["paged"]["counts"]["paged_attention"]
    del runs, eager, model, model32, net
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {cfg.name} phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"paged_attention": paged, **flash, "serve": serve}


def init_seamless(mixer: str):
    """``get_model(seamless_m4t_large_v2)`` with the ``mixer`` encoder at full
    width and depth, its weights drawn on the card from a CUDA generator
    seeded with SEED: (cfg, model, net); raises unless its (layers, encoder
    layers, parameters) are SEAMLESS_SIZES[mixer]."""
    import torch

    from repro_torch.configs.seamless_m4t_large_v2 import config
    from repro_torch.models.api import get_model

    cfg = config(mixer)
    model = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = card_init(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    n_enc = sum(p.numel() for p in net.encoder.parameters())
    plans = {k: p.describe() for k, p in model.plans.items()}
    print(f"init {cfg.name}: {cfg.num_encoder_layers} encoder layers ({mixer}), "
          f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, {cfg.attn.num_heads} heads "
          f"of {cfg.attn.head_dim}, vocab {cfg.vocab}: {n_params} parameters ({n_enc} in the "
          f"encoder; {n_params * 4 / 2**30:.2f} GiB fp32) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; plans {plans}", flush=True)
    if (cfg.num_layers, cfg.num_encoder_layers, n_params) != SEAMLESS_SIZES[mixer]:
        raise AssertionError(f"{cfg.name} is not at full size: {cfg.num_layers} + "
                             f"{cfg.num_encoder_layers} layers, {n_params} parameters")
    if mixer == "flare" and model.plans["infer"].backend != "packed":
        raise AssertionError(f"{cfg.name}: infer plan {plans['infer']}, not the fused kernel")
    return cfg, model, net


def seamless_window(net, cfg, batch, impl: str, plan, label: str, keep=()) -> dict:
    """One counted window: the launch counters read just before and just
    after one ``encdec_prefill`` of ``batch`` (``impl`` for the three
    attentions, ``plan`` for a FLARE encoder); ms and peak GiB. The flash
    calls whose index is in ``keep`` have their (q, k, v, output) copied
    into the result's ``calls``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import encdec_prefill

    kernel, calls, seen = ops.flash_kernel, {}, [0]

    def capturing(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        if seen[0] in keep:
            calls[seen[0]] = tuple(t.clone() for t in (q, k, v, out))
        seen[0] += 1
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.count_snapshot()
    ops.flash_kernel = capturing
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            logits, caches = encdec_prefill(net, batch, cfg, SEAMLESS_CAP, impl=impl, plan=plan)
        torch.cuda.synchronize()
    finally:
        ops.flash_kernel = kernel
    ms = (time.perf_counter() - t0) * 1e3
    delta = named_delta(before, ops.count_snapshot())
    peak = torch.cuda.max_memory_allocated() / 2**30
    b, s, _ = batch["embeds"].shape
    print(f"path {cfg.name} prefill {label} B={b} S_src={s} T={batch['tokens'].shape[1]} "
          f"{cfg.compute_dtype}: {ms:.3f} ms (host clock, first call), peak {peak:.2f} GiB; "
          f"launches {delta}", flush=True)
    if not bool(logits.isfinite().all()) or logits.shape != (b, cfg.vocab):
        raise AssertionError(f"{cfg.name} prefill {label}: logits {tuple(logits.shape)}, "
                             "not finite or not [B, vocab]")
    return dict(logits=logits, caches=caches, ms=ms, peak=peak, launches=delta, calls=calls)


def expect_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def seamless_greedy(model, net, logits, caches, label: str, *, profile: bool = False) -> dict:
    """SEAMLESS_NEW greedy ``decode_step``s after a prefill: the tokens (the
    prefill's argmax and one a step), eager ms a step, and the launches of
    the steps, which must be none (the decode step runs no port kernel).
    With ``profile``, one more step from the prefill's caches (a copy) is
    traced on the device after the timed ones."""
    import torch

    from repro_torch.kernels import ops

    tok = logits.argmax(-1)[:, None]
    toks = [tok]
    start = (tok, caches._replace(self_caches=[c._replace(k=c.k.clone(), v=c.v.clone())
                                               for c in caches.self_caches])) if profile else None
    torch.cuda.synchronize()
    before = ops.count_snapshot()
    t0 = time.perf_counter()
    for _ in range(SEAMLESS_NEW):
        logits, caches = model.decode_step(net, tok, caches)
        tok = logits.argmax(-1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SEAMLESS_NEW
    delta = ops.count_delta(before, ops.count_snapshot())
    if delta:
        raise AssertionError(f"{label} decode: launched {delta}; the decode step runs no kernel")
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"{label} decode: logits not finite")
    if profile:
        breakdown(lambda: model.decode_step(net, *start), f"{label} decode step (eager)")
    return dict(tokens=torch.cat(toks, dim=1).tolist(), ms=ms)


def seamless_flare_operands(net, cfg, embeds, dtype):
    """Encoder layer 0's FLARE q [H, M, D] and k, v [B, H, N, D] (strided
    split-head views) for ``embeds`` in ``dtype`` compute, as ``encode``
    gives them to the mixer."""
    import torch

    from repro_torch.core.flare import _split_heads
    from repro_torch.models.transformer import _norm
    from repro_torch.nn.modules import resmlp

    layer = net.encoder[0]
    fl = layer.attn
    h = fl.q_latent.shape[0]
    with torch.no_grad():
        xin = _norm(cfg, layer.norm1, embeds.to(dtype))
        return (fl.q_latent.detach().to(dtype), _split_heads(resmlp(fl.k_proj, xin), h),
                _split_heads(resmlp(fl.v_proj, xin), h))


def check_flare_seamless(checks: Checks, label: str, q, k, v) -> None:
    """The FLARE kernels (encode, decode, fused forward) on encoder layer 0's
    operands in their dtype, every batch element and head, against the
    plain version in fp64 on the same values (fp32 1e-5, bf16 1e-2 of max
    |plain|; the plain version on the operands themselves printed beside);
    each must reject the fp64 plain version with TILE tokens (encode,
    fused) or FLARE_LATENT_TILE latents (decode) left out. fp32 errors
    count into the rows' ``max_abs_err``, bf16 into records of their own."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    dtype = k.dtype
    key = str(dtype).removeprefix("torch.")
    b, h, n, d = k.shape
    print(f"kernels flare {label} (encoder layer 0's operands, B={b} H={h} M={q.shape[1]} "
          f"N={n} D={d} {key}, k/v strides {k.stride()}; held against the plain version in "
          "fp64):", flush=True)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    lat = FLARE_LATENT_TILE
    z64 = by_head(ref.flare_encode_ref, q64, k64, v64)
    z_drop = by_head(lambda qh, kh, vh: ref.flare_encode_ref(qh, kh[:, :, TILE:], vh[:, :, TILE:]),
                     q64, k64, v64)
    record = True if dtype == torch.float32 else None

    def hold(name, what, got, want, plain, drop):
        checks.hold(name, f"{what} {key}", got, want, dtype, atol=None, fp32_plain=plain,
                    record=record or f"{name} seamless {key}", dropped=drop)

    hold("flare_encode", "z", flare_encode(q, k, v), z64, by_head(ref.flare_encode_ref, q, k, v),
         {"token tile": z_drop})
    z_in = z64.to(dtype)   # the decode's input, the same for every version
    dec64 = by_head(ref.flare_decode_ref, q64, k64, z_in.double())
    dec_drop = by_head(lambda qh, kh, zh: ref.flare_decode_ref(qh[:, lat:], kh, zh[:, :, lat:]),
                       q64, k64, z_in.double())
    hold("flare_decode", "y", flare_decode(q, k, z_in), dec64,
         by_head(ref.flare_decode_ref, q, k, z_in), {"latent tile": dec_drop})
    del dec64, dec_drop
    y, z = flare_fused_fwd(q, k, v)[:2]
    plain = by_head(ref.flare_fused_fwd_ref, q, k, v)
    y64 = by_head(ref.flare_decode_ref, q64, k64, z64)
    y_drop = by_head(ref.flare_decode_ref, q64, k64, z_drop)
    hold("flare_fused_fwd", "y", y, y64, plain[0], {"token tile": y_drop})
    hold("flare_fused_fwd", "z", z, z64, plain[1], {"token tile": z_drop})
    checks.raise_failures(f"FLARE kernels on {label}")


def time_flare_seamless(q, k, v) -> dict:
    """CUDA-event times of the encode, the decode and the fused forward on
    encoder layer 0's operands, their plain versions (a head at a time) and
    the SDPA yardstick (one or two ``F.scaled_dot_product_attention``
    calls), beside the bound: the products (two a kernel, three fused) over
    the peak of the operands' dtype (bf16 tensor cores; fp32 CUDA cores),
    or each input read once and each output written once over 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    b, h, n, d = k.shape
    m = q.shape[1]
    es = k.element_size()
    peak = PEAK_BF16 if es == 2 else PEAK_FP32
    z = flare_encode(q, k, v)
    qb = q.expand(b, h, m, d)
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, scale=1.0)
    runs = {
        "flare_encode": (lambda: flare_encode(q, k, v),
                         lambda: by_head(ref.flare_encode_ref, q, k, v),
                         lambda: sdpa(qb, k, v)),
        "flare_decode": (lambda: flare_decode(q, k, z),
                         lambda: by_head(ref.flare_decode_ref, q, k, z),
                         lambda: sdpa(k, qb, z)),
        "flare_fused_fwd": (lambda: flare_fused_fwd(q, k, v),
                            lambda: by_head(ref.flare_fused_fwd_ref, q, k, v),
                            lambda: sdpa(k, qb, sdpa(qb, k, v))),
    }
    mnd = b * h * m * n * d
    qkv = es * (h * m * d + 2 * b * h * n * d)
    work = {   # (FLOP, bytes): each input read once, each output written once
        "flare_encode": (4 * mnd, qkv + es * b * h * m * d),
        "flare_decode": (4 * mnd, qkv + es * b * h * m * d),
        "flare_fused_fwd": (6 * mnd, qkv + es * b * h * (n + m) * d + 4 * b * h * (n + 2 * m)),
    }
    stats = {}
    for name, (kern, plain, lib) in runs.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BW * 1e3
        stats[name] = dict(ms=cuda_ms(kern, reps=10), plain_ms=cuda_ms(plain, reps=2),
                           library_ms=cuda_ms(lib, reps=5), bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"time {name} seamless encoder layer 0 (B={b} H={h} M={m} N={n} D={d}, "
              f"{k.dtype}): {stats[name]}", flush=True)
    return stats


@contextlib.contextmanager
def lose_frames(module, name: str, layer, rows: slice):
    """Within the block, every call of the mixer ``module.name`` on
    ``layer`` (its first argument; under autograd the forward and its
    recomputation) returns its output with ``rows`` of the token axis
    zeroed (a lost stretch of frames), the other layers' calls untouched."""
    fn = getattr(module, name)

    def lose(mixer, *args, **kw):
        out = fn(mixer, *args, **kw)
        if mixer is layer:
            out = out.clone()
            out[:, rows] = 0
        return out

    setattr(module, name, lose)
    try:
        yield
    finally:
        setattr(module, name, fn)


def seamless_variant(checks: Checks, mixer: str, device) -> dict:
    """One encoder variant at full size: init; the kernels at layer 0's
    operands; the kernel route's and the plain route's prefill windows in
    bf16 and fp32 (launches and routes asserted), the logits held, greedy
    tokens after each fp32 prefill equal; ms, peak GiB. Returns the
    kernels' records and the windows' launches by kernel row."""
    import gc

    import torch

    from repro_torch.config import replace
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.models import transformer
    from repro_torch.models.api import get_model

    t_var = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, net = init_seamless(mixer)
    flare = mixer == "flare"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    batch = {"embeds": torch.randn(SEAMLESS_B, SEAMLESS_SRC, cfg.d_model, generator=gen,
                                   device=device),
             "tokens": dense_tokens(cfg.vocab, SEAMLESS_B, SEAMLESS_T, SEED + 5, device)}
    scale = cfg.attn.head_dim ** -0.5
    plain_model = get_model(cfg, policy=MixerPolicy(backends=("sdpa",)))
    plan, plain_plan = model.plans.get("infer"), plain_model.plans.get("infer")
    record, launches = {}, collections.Counter()
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_layers

    # bf16, the config's compute dtype: the kernel route's counted window,
    # layer 0's flash calls captured from it
    enc_flash = 0 if flare else n_enc
    first = {"encoder self-attention": 0, "decoder self-attention": enc_flash,
             "cross-attention": enc_flash + 1}
    if flare:
        del first["encoder self-attention"]
    run = seamless_window(net, cfg, batch, "pallas", plan, "kernel route",
                          keep=set(first.values()))
    want = {"flash_attention": enc_flash + 2 * n_dec,
            "flash_attention[tensor_core]": enc_flash + 2 * n_dec}
    if flare:
        want["flare_fused_fwd"] = n_enc
    expect_launches(f"{cfg.name} bf16 kernel route", run["launches"], want)
    launches["flash_attention_tc"] += want["flash_attention"]
    launches["flare_fused_fwd"] += want.get("flare_fused_fwd", 0)
    for what, i in first.items():
        q, k, v, _ = run["calls"][i]
        causal = what == "decoder self-attention"
        check_flash_main(checks, f"{cfg.name} layer 0 {what}", (q, k, v), scale, causal=causal)
        if not flare:
            record[what] = time_flash_at(f"{cfg.name} layer 0 {what}", (q, k, v), scale,
                                         causal=causal)
    del run["calls"]
    if flare:
        for dtype in (torch.bfloat16, torch.float32):
            ops_l0 = seamless_flare_operands(net, cfg, batch["embeds"], dtype)
            check_flare_seamless(checks, f"{cfg.name} {dtype}", *ops_l0)
            record[str(dtype).removeprefix("torch.")] = time_flare_seamless(*ops_l0)
            del ops_l0
    torch.cuda.empty_cache()
    tc_want = ("flash_tc_kernel",) + (FWD_TC if flare else ())
    with torch.no_grad():
        prefill = lambda p, impl, c=cfg: transformer.encdec_prefill(
            net, batch, c, SEAMLESS_CAP, impl=impl, plan=p)
        assert_route(breakdown(lambda: prefill(plan, "pallas"),
                               f"{cfg.name} prefill kernel route bf16"),
                     f"{cfg.name} prefill kernel route bf16", tc_want,
                     refuse=("flash_bf16_kernel", "flash_tf32_kernel"))
        prefill_ms = cuda_ms(lambda: prefill(plan, "pallas"), reps=3)
        encode_ms = cuda_ms(lambda: transformer.encode(net, batch["embeds"], cfg, impl="pallas",
                                                       plan=plan), reps=3)
        plain_ms = cuda_ms(lambda: prefill(plain_plan, "chunked"), reps=3)
    plain = seamless_window(net, cfg, batch, "chunked", plain_plan, "plain route")
    expect_launches(f"{cfg.name} bf16 plain route", plain["launches"], {})
    rel = rel_err(run["logits"], plain["logits"])
    with torch.no_grad():
        layer0 = types.SimpleNamespace(encoder=net.encoder[:1], enc_norm=net.enc_norm)
        mem = {}
        for depth, sub in (("after layer 0", layer0), ("after the encoder", net)):
            got = transformer.encode(sub, batch["embeds"], cfg, impl="pallas", plan=plan)
            ref_mem = transformer.encode(sub, batch["embeds"], cfg, impl="chunked",
                                         plan=plain_plan)
            mem[depth] = rel_err(got, ref_mem)
            del got, ref_mem
    plain_logits = plain["logits"]
    print(f"{cfg.name} bf16 kernel route vs plain route: last-token logits rel {rel:.3g} "
          f"(limit {LM_TOL['bfloat16']:g}); encoder memory rel {mem} (limit "
          f"{SEAMLESS_MEM_TOL:g} where the logits do not hold)", flush=True)
    if not rel <= LM_TOL["bfloat16"]:
        bad = {k: r for k, r in mem.items() if not r <= SEAMLESS_MEM_TOL}
        print(f"{cfg.name} bf16: the logits differ by {rel / mem['after layer 0']:.3g}x the "
              "memory's difference after layer 0 (random-weight depth); the memory is held "
              "instead", flush=True)
        if bad:
            raise AssertionError(f"{cfg.name} bf16 kernel vs plain route: memory rel {bad}, "
                                 f"logits rel {rel:.3g}")
    eager = seamless_greedy(model, net, run["logits"], run["caches"], f"{cfg.name} bf16",
                            profile=True)
    torch.cuda.synchronize()
    figures = dict(prefill_ms=prefill_ms, prefill_plain_ms=plain_ms, encode_ms=encode_ms,
                   encoder_share=encode_ms / prefill_ms, decode_ms_per_step=eager["ms"],
                   peak_gib=run["peak"], bf16_logits_rel=rel, bf16_memory_rel=mem)
    del run, plain, eager
    torch.cuda.empty_cache()

    if flare:   # rows 1-2: the same model under the pallas policy (encode and decode kernels)
        pallas = get_model(cfg, policy=MixerPolicy(backends=("pallas",)))
        prun = seamless_window(net, cfg, batch, "pallas", pallas.plans["infer"],
                               "kernel route, pallas policy")
        want = {"flare_encode": n_enc, "flare_decode": n_enc, "flash_attention": 2 * n_dec,
                "flash_attention[tensor_core]": 2 * n_dec}
        expect_launches(f"{cfg.name} bf16 pallas policy", prun["launches"], want)
        for name in ("flare_encode", "flare_decode"):
            launches[name] += n_enc
        launches["flash_attention_tc"] += 2 * n_dec
        with torch.no_grad():
            assert_route(breakdown(lambda: prefill(pallas.plans["infer"], "pallas"),
                                   f"{cfg.name} prefill pallas policy bf16"),
                         f"{cfg.name} prefill pallas policy bf16", tc_want)
        print(f"{cfg.name} bf16 pallas policy vs plain route: last-token logits rel "
              f"{rel_err(prun['logits'], plain_logits):.3g}",
              flush=True)
        del prun
        torch.cuda.empty_cache()

    # fp32 compute: the kernel route's window (the TF32 flash kernel and the
    # fp32 FLARE kernels) against the plain route, a control, greedy tokens
    cfg32 = replace(cfg, compute_dtype="float32")
    model32 = get_model(cfg32)
    plain32 = get_model(cfg32, policy=MixerPolicy(backends=("sdpa",)))
    plan32, plain_plan32 = model32.plans.get("infer"), plain32.plans.get("infer")
    run32 = seamless_window(net, cfg32, batch, "pallas", plan32, "kernel route")
    want = {"flash_attention": enc_flash + 2 * n_dec, "flash_attention[fp32]": enc_flash + 2 * n_dec}
    if flare:
        want["flare_fused_fwd"] = n_enc
    expect_launches(f"{cfg.name} fp32 kernel route", run32["launches"], want)
    launches["flash_attention"] += want["flash_attention"]
    launches["flare_fused_fwd"] += want.get("flare_fused_fwd", 0)
    with torch.no_grad():
        assert_route(breakdown(lambda: prefill(plan32, "pallas", cfg32),
                               f"{cfg.name} prefill kernel route fp32"),
                     f"{cfg.name} prefill kernel route fp32",
                     ("flash_tf32_kernel",) + (FWD_TC if flare else ()),
                     refuse=("flash_tc_kernel", "flash_bf16_kernel"))
    plain_run32 = seamless_window(net, cfg32, batch, "chunked", plain_plan32, "plain route")
    expect_launches(f"{cfg.name} fp32 plain route", plain_run32["launches"], {})
    held(f"{cfg.name} prefill kernel route vs plain route fp32 (last-token logits)",
         run32["logits"], plain_run32["logits"], LM_TOL["float32"])
    lost = slice(SEAMLESS_SRC - SEAMLESS_LOST, SEAMLESS_SRC)
    with lose_frames(transformer, "flare_layer" if flare else "gqa_forward",
                     net.encoder[0].attn, lost):
        control = seamless_window(net, cfg32, batch, "chunked", plain_plan32,
                                  f"plain route, layer 0's mixer output zeroed on the last "
                                  f"{SEAMLESS_LOST} frames")
    rel_control = rel_err(control["logits"], plain_run32["logits"])
    print(f"{cfg.name} fp32 control: rel {rel_control:.3g} (must exceed "
          f"{LM_TOL['float32']:g})", flush=True)
    if not rel_control > LM_TOL["float32"]:
        raise AssertionError(f"{cfg.name}: the fp32 limit {LM_TOL['float32']} would pass a "
                             f"prefill that lost {SEAMLESS_LOST} frames (rel {rel_control:.3g})")
    del control
    toks = {}
    for label, r in (("kernel route", run32), ("plain route", plain_run32)):
        toks[label] = seamless_greedy(model32, net, r["logits"], r["caches"],
                                      f"{cfg.name} fp32 {label}")
    div = first_divergence(toks["kernel route"]["tokens"], toks["plain route"]["tokens"])
    if div is not None:
        raise AssertionError(f"{cfg.name} fp32: greedy tokens differ between the routes at "
                             f"sequence {div[0]}, token {div[1]}")
    print(f"{cfg.name} fp32: the {SEAMLESS_B} x {SEAMLESS_NEW + 1} greedy tokens are equal on "
          f"the kernel and the plain route; decode {toks['kernel route']['ms']:.3f} ms a step "
          "(eager, no kernel launched)", flush=True)
    figures.update(prefill_fp32_ms=run32["ms"], prefill_plain_fp32_ms=plain_run32["ms"],
                   decode_fp32_ms_per_step=toks["kernel route"]["ms"],
                   seconds=time.perf_counter() - t_var)
    print(f"seamless {cfg.name}: {figures}", flush=True)
    del run32, plain_run32, toks, model, model32, net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(record=record, launches=launches, figures=figures)


def seamless_phase(checks: Checks, device) -> dict:
    """seamless-m4t-large-v2 at full width and depth, the attention encoder
    and then the FLARE encoder (each freed before the next). Returns, by
    kernel row, this phase's records (``seamless_m4t``: times at its shapes
    and the counted windows' launches)."""
    import torch

    t_phase = time.perf_counter()
    attn = seamless_variant(checks, "attn", device)
    flare = seamless_variant(checks, "flare", device)
    launches = attn["launches"] + flare["launches"]
    out = {}
    for name in ("flash_attention_tc", "flash_attention"):
        out[name] = {what: rows[name] for what, rows in attn["record"].items()}
    for name in ("flare_encode", "flare_decode", "flare_fused_fwd"):
        out[name] = {dt: rows[name] for dt, rows in flare["record"].items()}
        for key in ("bfloat16",):
            out[name][key]["max_abs_err"] = checks.max_abs[f"{name} seamless {key}"]
    for name in out:
        out[name]["launches"] = launches[name]
    out["figures"] = {"attn": attn["figures"], "flare": flare["figures"]}
    # the phases after this one hold their peaks against limits: nothing of
    # the two models may stay allocated
    print(f"seamless phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    card_empty("seamless phase")
    return out


# --------------------------------------------------------------------------
# Training the encoder-decoder (both encoders) and RWKV-6 at full width and
# depth: the fused FLARE backward in bf16 at D=64 on a model's training path
# --------------------------------------------------------------------------


def launcher_batches(cfg, b: int, t: int):
    """The training launcher's step-keyed batches (``launch/train.py``):
    ``TokenStream`` tokens and labels [b, t] int32, and for the
    encoder-decoder standard normal source frames [b, t, d_model] fp32 from
    ``np.random.default_rng(step)``; the host ms of each feed kept in the
    function's ``feed_ms``."""
    import numpy as np

    from repro_torch.data.synthetic import TokenStream

    stream = TokenStream(cfg.vocab, t, seed=SEED)

    def batch_fn(step):
        t0 = time.perf_counter()
        batch = stream.global_batch(step, b, 1)
        if cfg.family in ("encdec", "audio"):
            batch["embeds"] = np.random.default_rng(step).standard_normal(
                (b, t, cfg.d_model)).astype("float32")
        batch_fn.feed_ms.append((time.perf_counter() - t0) * 1e3)
        return batch

    batch_fn.feed_ms = []
    return batch_fn


def named_delta(before: dict, after: dict) -> dict:
    """The launch counters that moved between two ``ops.count_snapshot``
    readings, by wrapper name (a route's count as ``name[route]``)."""
    from repro_torch.kernels import ops

    return {fn.__name__ + (f"[{route}]" if route else ""): n
            for (fn, route), n in ops.count_delta(before, after).items()}


def fit_family(label: str, model, net, batch_fn, num_mb: int, *, profile: bool) -> dict:
    """``Trainer.fit`` of the drawn ``net`` for FAMILY_STEPS steps, writing
    no checkpoint (the LM phases' full-size ones already round-trip). The
    launch counters are read as each microbatch's loss begins and after the
    fit, so each window holds one microbatch's forward, recomputation and
    backward; AdamW is timed by CUDA events inside each step; with
    ``profile`` one more step runs under the profiler after the fit. Returns
    the history, the windows, ms a step (the mean of steps 2 on; host clock,
    the feed included), AdamW ms, peak GiB, the profile and the seconds of
    the fit and of the profiled step."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer
    from repro_torch.train import steps as train_steps

    marks = []

    def loss(net_, mb):   # each microbatch's window starts here
        marks.append(ops.count_snapshot())
        return model.loss(net_, mb)

    update, events = train_steps.adamw_update, []

    def timed_update(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = update(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    class NoCheckpoints(Trainer):
        _writes = False   # this process writes no checkpoint

    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = TrainConfig(steps=FAMILY_STEPS, seed=SEED, checkpoint_dir=ckdir,
                           checkpoint_every=10 * FAMILY_STEPS, log_every=1)
        trainer = NoCheckpoints(dataclasses.replace(model, loss=loss, init=lambda seed: net),
                                tcfg, num_microbatches=num_mb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_steps.adamw_update = timed_update
        t0 = time.perf_counter()
        try:
            history = trainer.fit(batch_fn)
        finally:
            train_steps.adamw_update = update
        marks.append(ops.count_snapshot())
        torch.cuda.synchronize()
        seconds = {"fit": round(time.perf_counter() - t0, 1)}
        peak = torch.cuda.max_memory_allocated() / 2**30
        windows = [named_delta(a, b) for a, b in zip(marks, marks[1:])]
        adamw = [s.elapsed_time(e) for s, e in events]
        trace = None
        if profile:   # one more step, traced on the device
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=trainer.device)
                     for k, v in batch_fn(FAMILY_STEPS).items()}
            trace = traced(lambda: trainer._train_step(trainer.net, trainer.opt_state, batch))[1]
            del batch
            seconds["profiled step"] = round(time.perf_counter() - t0, 1)
        del trainer
    steps_ms = [1e3 * h["time"] for h in history]
    ms = sum(steps_ms[1:]) / len(steps_ms[1:])
    print(f"train {label} losses {[h['loss'] for h in history]}, grad_norm "
          f"{[h['grad_norm'] for h in history]}; ms/step {[round(t, 3) for t in steps_ms]} "
          f"(host clock, the feed included: "
          f"{[round(t, 1) for t in batch_fn.feed_ms[:FAMILY_STEPS]]} ms); AdamW "
          f"{[round(t, 3) for t in adamw]} ms (CUDA events in the step); peak {peak:.2f} GiB",
          flush=True)
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"train {label}: a loss or grad_norm is not finite")
    return dict(history=history, windows=windows, ms=ms, adamw_ms=sum(adamw) / len(adamw),
                peak=peak, trace=trace, seconds=seconds)


def expect_windows(label: str, windows: list, want: dict, num_mb: int) -> dict:
    """Every microbatch's window launched exactly ``want``; returns the
    fit's launches by wrapper name."""
    if len(windows) != FAMILY_STEPS * num_mb or any(w != want for w in windows):
        raise AssertionError(f"train {label}: launches a microbatch {windows}, expected "
                             f"{FAMILY_STEPS * num_mb} x {want}")
    total = collections.Counter()
    for w in windows:
        total.update(w)
    print(f"train {label}: launches a microbatch {want or 'none'} in each of the fit's "
          f"{len(windows)} microbatches ({FAMILY_STEPS} steps of {num_mb}): "
          f"{dict(total) or 'none'} in all", flush=True)
    return dict(total)


def train_line(label: str, fit: dict, flop: float, tokens: int, extra: str = "") -> tuple:
    """The phase's summary line: ms a step, tokens/s, model FLOP/s over the
    bf16 peak, AdamW ms, peak GiB and the profiled step's busy share.
    Returns (those figures, the profiled step's kernels as ``report`` gives
    them, or None)."""
    rate = flop / (fit["ms"] / 1e3)
    busy = seen = None
    if fit["trace"] is not None:
        seen = report(*fit["trace"], f"train {label} step {FAMILY_STEPS + 1} (after the fit)",
                      top=12)
        busy = None if seen is None else sum(seen[0].values()) / seen[1]
    out = dict(ms=fit["ms"], tokens_s=tokens / fit["ms"] * 1e3, flop_share=rate / PEAK_BF16,
               adamw_ms=fit["adamw_ms"], peak_gib=fit["peak"], busy=busy)
    print(f"train {label}: {fit['ms']:.3f} ms/step (mean of steps 2-{FAMILY_STEPS}), "
          f"{out['tokens_s']:.1f} tokens/s{extra}, model FLOP/s {rate / 1e12:.1f} T = "
          f"{100 * out['flop_share']:.2f}% of {PEAK_BF16 / 1e12:.0f} TFLOP/s, AdamW "
          f"{fit['adamw_ms']:.3f} ms, peak {fit['peak']:.2f} GiB, busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}", flush=True)
    return out, seen


def check_bwd_seamless(checks: Checks, q, k, v, dy) -> dict:
    """Row 4 on encoder layer 0's q, k, v in their dtype and a seeded dy, at
    the fit's batch: dq, dk, dv against the plain backward in fp64 on the
    kernel forward's residuals (widened), a head at a time. bf16 (the
    model's compute dtype) beyond bf16's output rounding
    (``Checks.hold_rounded``: the kernel computes in fp32, every fp32
    operand split in two TF32 parts, and rounds only its outputs); fp32 at
    1e-5 of max |plain|. dk and dv must reject the plain backward with
    TOKEN_TILE tokens left out of dZ's sum, dq the one whose dZ lost
    FLARE_LATENT_TILE latents. Returns the row's record at this shape: the
    kernel's, the plain version's and SDPA's times, the bound, the largest
    error and ptxas's registers and spills of the D=64 instances."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd

    b, h, n, d = k.shape
    key = str(k.dtype).removeprefix("torch.")
    print(f"kernels flare_fused_bwd seamless encoder layer 0 (B={b} H={h} M={q.shape[1]} N={n} "
          f"D={d} {key}, seeded dy; held against the plain backward in fp64):", flush=True)
    y, *res = flare_fused_fwd(q, k, v)
    inputs = (q, k, v, *res, y, dy)
    got = flare_fused_bwd(*inputs)
    torch.cuda.synchronize()
    wide = tuple(t.to(torch.float64) for t in inputs)
    want = bwd_by_head(*wide)
    lost_tokens = bwd_by_head(*wide, drop="tokens", tile=TOKEN_TILE)
    lost_latents = bwd_by_head(*wide, drop="dz latents", tile=FLARE_LATENT_TILE)
    plain = bwd_by_head(*inputs) if k.dtype == torch.float32 else None
    err = 0.0
    for i, what in enumerate(GRADS):
        dropped = ({f"{FLARE_LATENT_TILE}-latent tile of dZ": lost_latents[i]} if what == "dq"
                   else {f"{TOKEN_TILE}-token tile of dZ": lost_tokens[i]})
        if k.dtype == torch.bfloat16:
            checks.hold_rounded("flare_fused_bwd", f"{what} bf16", got[i], want[i],
                                dropped=dropped)
            err = max(err, max_err(got[i], want[i]))
        else:
            checks.hold("flare_fused_bwd", f"{what} {key}", got[i], want[i], k.dtype, atol=None,
                        record=f"flare_fused_bwd seamless {key}", dropped=dropped,
                        fp32_plain=plain[i])
    checks.raise_failures(f"backward kernel on seamless-m4t's operands ({key})")
    del want, lost_tokens, lost_latents, wide, got, plain
    torch.cuda.empty_cache()
    stats = {name: x for name, x in time_bwd(q, k, v, dy, y, res).items()
             if not name.startswith("floor_")}
    stats["max_abs_err"] = (err if k.dtype == torch.bfloat16
                            else checks.max_abs[f"flare_fused_bwd seamless {key}"])
    width = "bf16" if k.dtype == torch.bfloat16 else "f32"
    stats["ptxas"] = {row.split()[0]: " ".join(row.split()[3:])
                      for row in ptxas_summary(_build.build_log)
                      if row.split()[1:3] == [width, "D=64"]
                      and row.split()[0] in ("dz", "dkv", "dq")}
    print(f"time flare_fused_bwd seamless encoder layer 0 (B={b} H={h} M={q.shape[1]} N={n} "
          f"D={d}, {key}): {stats}", flush=True)
    return stats


def loss_and_grads(model, net, mb) -> tuple:
    """``model.loss`` on ``mb`` and its gradients ({name: tensor}), the net's
    ``.grad`` cleared after."""
    for p in net.parameters():
        p.grad = None
    loss = model.loss(net, mb)
    loss.backward()
    grads = {name: p.grad for name, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    return loss.item(), grads


def tree_rel(grads: dict, want: dict) -> tuple:
    """The largest gradient difference over the tree's max |g| of ``want``,
    and the leaf where it is."""
    scale = max(g.abs().max().item() for g in want.values())
    name, err = max(((k, max_err(grads[k], want[k])) for k in want), key=lambda kv: kv[1])
    return err / scale, name


def check_seamless_steps(cfg, model, net, mb) -> dict:
    """Check (b): the whole train step's loss and gradients in fp32 compute
    on one microbatch (the fit's unit of work) under the ``packed`` plan
    (2 x layers fused forwards and layers fused backwards asserted) against
    the same weights under the plain ``sdpa`` plan: the loss and every
    gradient leaf within STEP_TOL of the tree's max |g|, which the packed
    step with encoder layer 0's mixer output zeroed on the last
    SEAMLESS_LOST frames must fail. Check (c): the bf16 step's loss (the
    fit's plan) against the ``sdpa`` plan's bf16 loss within LM_TOL; its
    gradients' distance printed, not held (random weights amplify bf16
    rounding over the encoder's 24 layers)."""
    import torch

    from repro_torch.config import replace
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_model

    cfg32 = replace(cfg, compute_dtype="float32")
    packed32 = get_model(cfg32)
    plain32 = get_model(cfg32, policy=MixerPolicy(backends=("sdpa",)))
    plans = {k: p.plans["train"].describe() for k, p in (("packed", packed32),
                                                         ("sdpa", plain32))}
    if packed32.plans["train"].backend != "packed" or plain32.plans["train"].backend != "sdpa":
        raise AssertionError(f"{cfg.name} fp32 train plans {plans}")
    n = cfg.num_encoder_layers
    before = ops.count_snapshot()
    ref_loss, ref = loss_and_grads(plain32, net, mb)
    plain_launches = named_delta(before, ops.count_snapshot())
    before = ops.count_snapshot()
    loss, grads = loss_and_grads(packed32, net, mb)
    launches = named_delta(before, ops.count_snapshot())
    rel, leaf = tree_rel(grads, ref)
    del grads
    src = mb["embeds"].shape[1]
    with lose_frames(transformer, "flare_layer", net.encoder[0].attn,
                     slice(src - SEAMLESS_LOST, src)):
        lost_loss, grads = loss_and_grads(packed32, net, mb)
    rel_lost, leaf_lost = tree_rel(grads, ref)
    del grads, ref
    torch.cuda.empty_cache()
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    lost_loss_rel = abs(lost_loss - ref_loss) / abs(ref_loss)
    ok = max(loss_rel, rel) <= STEP_TOL
    print(f"train {cfg.name} step fp32 B={mb['tokens'].shape[0]} packed vs sdpa ({plans}): loss "
          f"{loss:.9g} / {ref_loss:.9g} (rel {loss_rel:.3g}), gradients rel {rel:.3g} of the "
          f"tree's max |g| at {leaf} (limit {STEP_TOL:g}); layer 0's mixer output zeroed on the "
          f"last {SEAMLESS_LOST} frames: loss rel {lost_loss_rel:.3g}, gradients rel "
          f"{rel_lost:.3g} at {leaf_lost}; launches packed {launches}, sdpa "
          f"{plain_launches or 'none'}" + ("" if ok else "  FAILED"), flush=True)
    want = {"flare_fused_fwd": 2 * n, "flare_fused_bwd": n}
    if launches != want or plain_launches:
        raise AssertionError(f"{cfg.name} fp32 step: launches {launches} (expected {want}), "
                             f"sdpa {plain_launches}")
    if not ok:
        raise AssertionError(f"{cfg.name} fp32 step: packed vs sdpa loss rel {loss_rel:.3g}, "
                             f"gradients rel {rel:.3g} at {leaf}")
    if not max(lost_loss_rel, rel_lost) > STEP_TOL:
        raise AssertionError(f"{cfg.name}: the step limit {STEP_TOL} would pass a step that lost "
                             f"{SEAMLESS_LOST} frames (rel {rel_lost:.3g})")
    plain16 = get_model(cfg, policy=MixerPolicy(backends=("sdpa",)))
    ref_loss16, ref16 = loss_and_grads(plain16, net, mb)
    loss16, grads16 = loss_and_grads(model, net, mb)
    rel16, leaf16 = tree_rel(grads16, ref16)
    del grads16, ref16
    torch.cuda.empty_cache()
    loss_rel16 = abs(loss16 - ref_loss16) / abs(ref_loss16)
    ok = loss_rel16 <= LM_TOL["bfloat16"]
    print(f"train {cfg.name} step bf16 packed vs sdpa: loss {loss16:.6f} / {ref_loss16:.6f} (rel "
          f"{loss_rel16:.3g}, limit {LM_TOL['bfloat16']:g}); gradients rel {rel16:.3g} of the "
          f"tree's max |g| at {leaf16} (printed, not held)" + ("" if ok else "  FAILED"),
          flush=True)
    if not ok:
        raise AssertionError(f"{cfg.name} bf16 step: packed vs sdpa loss rel {loss_rel16:.3g}")
    return dict(fp32_loss_rel=loss_rel, fp32_grad_rel=rel, control_grad_rel=rel_lost,
                bf16_loss_rel=loss_rel16, bf16_grad_rel=rel16)


def seamless_flop(net, b: int, t: int) -> float:
    """6 x parameters x the tokens they see, the recomputation left out: the
    encoder's over b * t source frames, the decoder's and the head's over
    b * t target tokens (the embedding table is a lookup, no product)."""
    n_enc = sum(p.numel() for p in (*net.encoder.parameters(), *net.enc_norm.parameters()))
    n_all = sum(p.numel() for p in net.parameters())
    return 6.0 * b * t * (n_enc + n_all - n_enc - net.embed.table.numel())


def train_seamless_variant(checks: Checks, mixer: str, device) -> dict:
    """One encoder variant of seamless-m4t-large-v2 trained at full size
    (the module docstring's phase 16d). Returns the step's figures and, for
    the FLARE encoder, row 4's records and the fit's launches."""
    import gc

    import torch

    from repro_torch.backends import autotune

    t_var = clock = time.perf_counter()
    parts = {}

    def part(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        parts[name], clock = round(now - clock, 1), now

    cfg, model, net = init_seamless(mixer)
    flare = mixer == "flare"
    num_mb = SEAMLESS_TRAIN_B // cfg.microbatch
    plan = model.plans.get("train")
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16" or (
            flare and plan.backend != "packed"):
        raise AssertionError(f"{cfg.name}: remat {cfg.remat}, compute {cfg.compute_dtype}, "
                             f"train plan {plan and plan.describe()}")
    batch_fn = launcher_batches(cfg, SEAMLESS_TRAIN_B, LM_TRAIN_T)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch_fn(0).items()}
    batch_fn.feed_ms.clear()
    mb = {k: v[:cfg.microbatch] for k, v in batch.items()}
    print(f"train {cfg.name}: train plan {plan and plan.describe()} in {cfg.compute_dtype}; "
          f"the launcher's batches: B={SEAMLESS_TRAIN_B} x {LM_TRAIN_T} source frames (standard "
          f"normal) and {LM_TRAIN_T} target tokens, {num_mb} microbatches of {cfg.microbatch}, "
          f"{FAMILY_STEPS} steps; {cfg.param_dtype} parameters, remat {cfg.remat}", flush=True)
    out = {}
    if flare:
        q, k, _ = seamless_flare_operands(net, cfg, mb["embeds"], torch.bfloat16)
        print(f"train {cfg.name}: a microbatch's FLARE call (B={cfg.microbatch}) takes launch "
              f"parameters {autotune.launch_params(plan, q, k, 'packed') or 'the defaults'}",
              flush=True)
        gen = torch.Generator().manual_seed(SEED + 1)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = seamless_flare_operands(net, cfg, batch["embeds"], dtype)
            b, h, n, d = k.shape
            dy = torch.randn(b, n, h, d, generator=gen).to(device, dtype).transpose(1, 2)
            out[str(dtype).removeprefix("torch.")] = check_bwd_seamless(checks, q, k, v, dy)
        del q, k, v, dy
        torch.cuda.empty_cache()
        part("init, check (a)")
        out["steps"] = check_seamless_steps(cfg, model, net, mb)
        part("checks (b), (c)")
    else:
        part("init")
    del batch, mb
    fit = fit_family(cfg.name, model, net, batch_fn, num_mb, profile=flare)
    clock += sum(fit["seconds"].values())
    parts.update(fit["seconds"])
    want = ({"flare_fused_fwd": 2 * cfg.num_encoder_layers,
             "flare_fused_bwd": cfg.num_encoder_layers} if flare else {})
    out["launches"] = expect_windows(cfg.name, fit["windows"], want, num_mb)
    tokens = SEAMLESS_TRAIN_B * LM_TRAIN_T
    out["figures"], seen = train_line(
        cfg.name, fit, seamless_flop(net, SEAMLESS_TRAIN_B, LM_TRAIN_T), tokens,
        f" of target tokens ({2 * tokens / fit['ms'] * 1e3:.1f} with the source frames)")
    if flare:
        assert_route(seen, f"train {cfg.name} step", FLARE_BWD16,
                     refuse=("flash_tc_kernel", "flash_tf32_kernel", "flash_bf16_kernel"))
        fused = {k: ms for k, ms in seen[0].items() if any(n in k for n in FLARE_BWD16)}
        print(f"train {cfg.name} step: the fused FLARE kernels {sum(fused.values()):.3f} ms of "
              f"{sum(seen[0].values()):.3f} ms device time "
              f"({100 * sum(fused.values()) / sum(seen[0].values()):.1f}%): "
              + ", ".join(f"{k.split('<')[0].split('::')[-1]} {ms:.3f}" for k, ms in
                          sorted(fused.items(), key=lambda kv: -kv[1])), flush=True)
    out["figures"]["losses"] = [h["loss"] for h in fit["history"]]
    del fit, model, net
    gc.collect()
    torch.cuda.empty_cache()
    part("report, free")
    out["figures"]["seconds"] = time.perf_counter() - t_var
    print(f"train {cfg.name} variant: {out['figures']['seconds']:.1f} s; by part {parts}",
          flush=True)
    return out


def card_empty(label: str) -> None:
    """The phase freed what it allocated on the card (under EMPTY_GIB)."""
    import torch

    left = torch.cuda.memory_allocated() / 2**30
    print(f"{label}: {left:.3f} GiB still allocated", flush=True)
    if not left < EMPTY_GIB:
        raise AssertionError(f"{label}: {left:.3f} GiB still allocated after the phase")


def train_seamless_phase(checks: Checks, device) -> dict:
    """seamless-m4t-large-v2 trained at full width and depth, the FLARE
    encoder and then the attention encoder (each freed before the next).
    Returns, by variant, row 4's records at its shape, the fused kernels'
    launches in the fit and the step's figures."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {mixer: train_seamless_variant(checks, mixer, device) for mixer in ("flare", "attn")}
    print(f"train seamless phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    card_empty("train seamless phase")
    return out


def wkv_operands(cfg, net, tokens):
    """Layer 0's WKV operands (r, k, v, w, u) for ``tokens``, bf16 compute,
    as ``rwkv6_time_mix`` gives them to the WKV."""
    import torch

    from repro_torch.models import rwkv_lm, ssm
    from repro_torch.nn.modules import layernorm

    layer = net.layers[0]
    with torch.no_grad():
        x = layernorm(layer.ln1, rwkv_lm._embed(net, tokens, cfg))
        r, k, v, w, _ = ssm.rwkv6_wkv_operands(layer, x, cfg.ssm)
    return r, k, v, w, layer.u.detach()


def check_wkv_grads(cfg, net, tokens) -> dict:
    """Autograd through layer 0's chunked WKV (fp32, the training path's
    form) on the model's own operands for ``tokens`` (the fit's first WKV_T
    tokens), against autograd through the scan in fp64 on the same values:
    the gradients of sum(y * dy) (a seeded dy) as to r, k, v, w and u, each
    within GRAD_TOL's fp32 limit of its max |g|; the chunked form run a
    chunk at a time from a zero state (the inter-chunk term dropped) must
    fail it."""
    import torch

    from repro_torch.models import ssm

    chunk, t = cfg.ssm.chunk, tokens.shape[1]
    ops = wkv_operands(cfg, net, tokens)
    dy = torch.randn(ops[0].shape, generator=torch.Generator().manual_seed(SEED + 4),
                     dtype=torch.float64).to(tokens.device)

    def grads(fn, dtype):
        leaves = [x.detach().to(dtype).requires_grad_() for x in ops]
        (fn(*leaves) * dy.to(dtype)).sum().backward()
        return [x.grad for x in leaves]

    def alone(r, k, v, w, u):   # each chunk from a zero state
        cut = [x.reshape(t // chunk, chunk, *x.shape[2:]) for x in (r, k, v, w)]
        return ssm.rwkv6_wkv_chunked(*cut, u, chunk=chunk)[0].reshape(r.shape)

    t0 = time.perf_counter()
    got = grads(lambda *xs: ssm.rwkv6_wkv_chunked(*xs, chunk=chunk)[0], torch.float32)
    want = grads(lambda *xs: ssm.rwkv6_wkv_scan(*xs)[0], torch.float64)
    lost = grads(alone, torch.float64)
    rels = {f"d{name}": rel_err(g, w_) for name, g, w_ in zip("rkvwu", got, want)}
    lost_rels = {f"d{name}": rel_err(x, w_) for name, x, w_ in zip("rkvwu", lost, want)}
    tol = GRAD_TOL["float32"]
    print(f"wkv rwkv6-3b layer 0 gradients T={t} (H={ops[0].shape[2]} D={ops[0].shape[3]}, chunk "
          f"{chunk}) fp32 chunked vs fp64 scan, over each max |g| (limit {tol:g}): "
          f"{', '.join(f'{k_} {e:.3g}' for k_, e in rels.items())}; chunks alone (the "
          f"inter-chunk term dropped): {', '.join(f'{k_} {e:.3g}' for k_, e in lost_rels.items())}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    if not max(rels.values()) <= tol:
        raise AssertionError(f"rwkv6 WKV gradients off the fp64 scan: {rels}")
    if not max(lost_rels.values()) > tol:
        raise AssertionError(f"the WKV gradient limit {tol} would pass a chunked form without "
                             f"its inter-chunk term ({lost_rels})")
    return rels


def train_rwkv_phase(checks: Checks, device) -> dict:
    """RWKV-6 3B trained at full width and depth (the module docstring's
    phase 16e). Returns the step's figures."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, net = init_recurrent("rwkv6_3b", RWKV_SIZE)
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: remat {cfg.remat}, compute {cfg.compute_dtype}")
    num_mb = LM_TRAIN_B // cfg.microbatch
    batch_fn = launcher_batches(cfg, LM_TRAIN_B, LM_TRAIN_T)
    print(f"train {cfg.name}: the launcher's batches B={LM_TRAIN_B} x T={LM_TRAIN_T}, {num_mb} "
          f"microbatches of {cfg.microbatch}, {FAMILY_STEPS} steps; {cfg.compute_dtype} compute, "
          f"{cfg.param_dtype} parameters, remat {cfg.remat}; no kernel (the WKV is plain torch, "
          "as in the reference)", flush=True)
    first = torch.as_tensor(batch_fn(0)["tokens"][:1, :WKV_T], device=device)
    batch_fn.feed_ms.clear()
    parts = {"init": round(time.perf_counter() - t_phase, 1)}
    t0 = time.perf_counter()
    rels = check_wkv_grads(cfg, net, first)
    parts["wkv gradients"] = round(time.perf_counter() - t0, 1)
    fit = fit_family(cfg.name, model, net, batch_fn, num_mb, profile=True)
    parts.update(fit["seconds"])
    t0 = time.perf_counter()
    expect_windows(cfg.name, fit["windows"], {}, num_mb)
    n_params = sum(p.numel() for p in net.parameters())
    tokens = LM_TRAIN_B * LM_TRAIN_T
    figures = train_line(cfg.name, fit, 6.0 * n_params * tokens, tokens)[0]
    losses = [h["loss"] for h in fit["history"]]
    ln_v = math.log(cfg.vocab)
    near = abs(losses[0] / ln_v - 1)
    print(f"train {cfg.name}: step 1's loss {losses[0]:.6f} against ln(vocab) {ln_v:.6f} (rel "
          f"{near:.3g}, limit {LOSS_NEAR:g}; at random init that holds whatever the mixer "
          "computes: the WKV gradient check is the one that counts)", flush=True)
    if not near <= LOSS_NEAR:
        raise AssertionError(f"{cfg.name}: step 1's loss {losses[0]} is not near ln(vocab)")
    del fit, model, net
    gc.collect()
    torch.cuda.empty_cache()
    parts["report, free"] = round(time.perf_counter() - t0, 1)
    figures.update(losses=losses, wkv_grad_rel=rels, seconds=time.perf_counter() - t_phase)
    print(f"train rwkv6 phase: {figures['seconds']:.1f} s; by part {parts}", flush=True)
    card_empty("train rwkv6 phase")
    return figures


def only_phases() -> dict:
    """The phases ``--only`` runs alone (after the build and the device
    lines), each from its own set-up: {name: fn(checks, device)}."""
    def spectral(checks, device):
        from repro_torch.config import SHAPES
        from repro_torch.configs import get_config
        from repro_torch.data.pde_data import pointcloud_batch
        from repro_torch.models.api import get_model

        s40 = SHAPES["pde_40k"]
        net = get_model(get_config("flare_pde")).init(SEED)
        b40 = pointcloud_batch(SEED, 0, s40.global_batch, grid=256, num_points=s40.seq_len)
        spectral_phase(net, b40["x"])

    def baselines(checks, device):
        from repro_torch.configs import get_config

        pde_baselines(checks, get_config("flare_pde"), device)

    phases = {"paged": check_paged_small, "flash": check_flash_small, "spectral": spectral,
              "tune": lambda checks, device: tune_phase(checks, device),
              "lm": lm_phases, "phi3": lambda checks, device: phi3_phases(checks, device),
              "pde_baselines": baselines}
    for arch, params in (("deepseek_v2_lite_16b", DEEPSEEK_PARAMS),
                         ("minicpm3_4b", MINICPM3_PARAMS)):
        phases[arch] = lambda checks, device, arch=arch, params=params: mla_phase(
            checks, arch, params, device)
    phases["rwkv6_3b"], phases["zamba2_7b"] = rwkv_phase, zamba_phase
    phases["seamless_m4t_large_v2"] = seamless_phase
    phases["train_seamless_m4t_large_v2"] = train_seamless_phase
    phases["train_rwkv6_3b"] = train_rwkv_phase
    return phases


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one GPU (see the "
                                 "module docstring); with no argument, every phase.")
    ap.add_argument("--only", choices=sorted(only_phases()),
                    help="run the build, the device lines and this phase alone")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "csrc" / "flare.cu").is_file():
        print("chip_smoke.py: run it from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = gpu_line()
    print(f"gpu: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    import tempfile

    from repro_torch.backends import autotune
    from repro_torch.kernels import _build

    # every phase but ``tune`` runs the kernels' default launch parameters:
    # autotuning off, and an empty cache of this run's own
    empty_cache = tempfile.TemporaryDirectory(prefix="autotune_")
    os.environ[autotune.CACHE_ENV] = str(Path(empty_cache.name) / "autotune.json")
    os.environ.pop("REPRO_AUTOTUNE", None)
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s; by source, "
          f"from the start: {_build.source_seconds})")
    print("\n".join(ptxas_summary(_build.build_log)), flush=True)

    checks = Checks()
    if args.only:
        only_phases()[args.only](checks, device)
        checks.raise_failures(args.only)
        print(f"chip_smoke.py --only {args.only}: {time.perf_counter() - t_start:.1f} s",
              flush=True)
        print(card)
        print(json.dumps({"ok": True, "only": args.only,
                          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}))
        return 0
    marks, t_mark = {}, [t_start]

    def mark(name: str) -> None:
        """The seconds since the last mark, under ``name``, for the phase line."""
        now = time.perf_counter()
        marks[name], t_mark[0] = round(now - t_mark[0], 1), now

    mark("build")
    check_small(checks, device)
    check_wide(checks, device)
    check_paged_small(checks, device)
    check_flash_small(checks, device)
    mark("kernels small")

    from repro_torch.configs import get_config
    from repro_torch.config import SHAPES
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.data.pde_data import darcy_batch, pointcloud_batch
    from repro_torch.models.api import get_model

    cfg = get_config("flare_pde")
    model = get_model(cfg)
    plan = model.plans["infer"].describe()
    print(f"model {cfg.name}: plans {{infer: {plan}, train: {model.plans['train'].describe()}}}"
          " (train: the fused forward and backward kernels through autograd)", flush=True)
    if model.plans["infer"].backend != "packed":
        raise AssertionError(f"infer plan {plan} is not the fused kernel")
    net = model.init(SEED)
    s40, s1m = SHAPES["pde_40k"], SHAPES["pde_1m"]
    t0 = time.perf_counter()
    b40 = pointcloud_batch(SEED, 0, s40.global_batch, grid=256, num_points=s40.seq_len)
    b1m = darcy_batch(SEED, 1, s1m.global_batch, grid=int(math.isqrt(s1m.seq_len)))
    torch.cuda.synchronize()
    print(f"data: pde_40k {tuple(b40['x'].shape)}, pde_1m {tuple(b1m['x'].shape)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # each kernel on the operands the main path gives it, at both shapes; the
    # backward with a seeded dy laid out as the model's [B, N, H, D] gradient
    gen = torch.Generator().manual_seed(SEED + 1)
    stats, refs = {}, {}
    for label, batch in (("pde_40k", b40), ("pde_1m", b1m)):
        ops = mixer_operands(net, batch["x"])
        refs[label] = check_main(checks, label, *ops)
        b, h, n, d = ops[1].shape
        dy = torch.randn(b, n, h, d, generator=gen).to(device).transpose(1, 2)
        y, res, grads64, bwd_refs = check_bwd_main(checks, label, *ops, dy)
        refs[label].update(bwd_refs)
        # the sharded mixer's entry points on the same operands, against the same fp64
        check_shard(checks, label, *ops, dy, refs[label]["fwd64"][0], grads64)
        del grads64, bwd_refs
        times = time_kernels(*ops)
        times["flare_fused_bwd"] = time_bwd(*ops, dy, y, res)
        times.update(time_shard(*ops, dy))
        for name, st in times.items():
            print(f"time {name} {label} fp32: {st}", flush=True)
        if label == "pde_40k":
            stats = times
        del ops, dy, y, res
        torch.cuda.empty_cache()
    mark("pde kernels")
    # the autotuner's search at both shapes, on a cache of its own, its
    # candidates held against the fp64 references of the checks above: each
    # tuned row carries its default's and its winner's ms
    for name, tuned in tune_phase(checks, device, net, {"pde_40k": b40, "pde_1m": b1m},
                                  refs).items():
        stats[name]["tuned"] = tuned
    del refs
    torch.cuda.empty_cache()
    mark("tune")

    packed = drive(model, net, {"pde_40k": (b40, 3), "pde_1m": (b1m, 2)}, "packed")
    pallas_model = get_model(cfg, policy=MixerPolicy(backends=("pallas",)))
    pallas = drive(pallas_model, net, {"pde_40k": (b40, 3)}, "pallas")
    assert_route(breakdown(lambda: model.forward(net, b40), "packed pde_40k"), "packed pde_40k",
                 FWD_TC)
    breakdown(lambda: model.forward(net, b1m), "packed pde_1m")
    assert_route(breakdown(lambda: pallas_model.forward(net, b40), "pallas pde_40k"),
                 "pallas pde_40k", FWD_TC)
    c_pk, c_pl = packed["counts"], pallas["counts"]
    if not (c_pk["flare_fused_fwd"] > 0 and c_pk["flare_encode"] == c_pk["flare_decode"]
            == c_pk["flare_fused_bwd"] == 0):
        raise AssertionError(f"packed path launches {c_pk}")
    if not (c_pl["flare_encode"] > 0 and c_pl["flare_decode"] > 0
            and c_pl["flare_fused_fwd"] == c_pl["flare_fused_bwd"] == 0):
        raise AssertionError(f"pallas path launches {c_pl}")

    # the kernel paths against the plain path on the same weights, every
    # batch element (the plain path runs one at a time: its scores are
    # [H, M, N] per element)
    plain_model = get_model(cfg, policy=MixerPolicy(backends=("sdpa",)))
    y_plain = torch.cat([plain_model.forward(net, {"x": b40["x"][i:i + 1]})
                         for i in range(s40.global_batch)])
    scale = y_plain.abs().max().item()
    for label, out in (("packed", packed["outs"]["pde_40k"]), ("pallas", pallas["outs"]["pde_40k"])):
        err = max_err(out, y_plain)
        print(f"path {label} vs sdpa at B={s40.global_batch} N={s40.seq_len} over "
              f"{cfg.num_layers} blocks: max|plain| {scale:.4g}, max abs err {err:.3g} "
              f"(atol {PATH_TOL}), rel {err / scale:.3g} (rtol {PATH_TOL})", flush=True)
        if not (err <= PATH_TOL and err / scale <= PATH_TOL):
            raise AssertionError(f"{label} path differs from the plain path by {err}")
    del packed, pallas, y_plain, b1m
    torch.cuda.empty_cache()
    spectral_phase(net, b40["x"])
    torch.cuda.empty_cache()
    # the paged backend: block 0's encode through the paged kernel, then the
    # model's forward under it (a counted window)
    check_paged_main(checks, "flare_pde encode block 0 pde_40k B=1",
                     encode_operands(net, b40["x"][:1]))
    torch.cuda.empty_cache()
    paged_counts = path_pde_paged(cfg, net, b40, checks)
    torch.cuda.empty_cache()

    # training: the fused forward and backward kernels under autograd
    trained = train(cfg, s40)
    torch.cuda.empty_cache()
    trained_1m = train_1m(cfg, s1m)
    torch.cuda.empty_cache()
    # a comparison, not a main-path run: its launches are checked there, not counted
    train_paths_agree(cfg)
    # launches: every counted window of the main paths (inference under
    # packed and pallas, the training fit and the pde_1m train steps)
    for name in stats:
        stats[name]["launches"] = sum(c[name] for c in (c_pk, c_pl, trained["counts"],
                                                        trained_1m))
    # the sequence-parallel trainer on a process group: the shard entry
    # points' launches are those of its pde_40k and pde_1m fits
    for name, n in train_sharded(cfg, s40, s1m).items():
        stats[name]["launches"] = n
    torch.cuda.empty_cache()
    # a comparison: two ranks sharing the card against the packed path
    train_two_ranks(cfg)
    del net, b40
    torch.cuda.empty_cache()
    mark("pde")
    # the causal FLARE LM: its launches are those of its forward and requests windows
    stats["flare_causal_chunk"] = lm_phases(checks, device)
    mark("lm")
    # flare_lm trained at full size (its serving net freed): no kernel launches
    t0 = time.perf_counter()
    train_lm("flare_lm", FLARE_LM_SIZE)
    print(f"train flare-lm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    mark("train flare-lm")
    # qwen2-1.5b served from the paged pool: the launches of its kernel route's
    # window and of the paged FLARE path's
    cfg_q, model_q, net_q = init_dense_lm("qwen2_1_5b", QWEN2_SIZE)
    stats["paged_attention"] = qwen2_phases(checks, cfg_q, model_q, net_q)
    stats["paged_attention"]["launches"] += paged_counts["paged_attention"]
    mark("serve qwen2")
    # the same qwen2 served with the prefix cache: the cache-on run's launches
    stats["paged_attention"]["launches"] += prefix_phase(cfg_q, model_q, net_q)
    mark("serve prefix")
    # the serving launcher at full size in a process of its own: warmup, then
    # no decode build while serving and no host sync a step
    launcher_run()
    mark("launcher")
    # the dense family's prefill through the flash kernels: the tensor-core
    # kernel's launches are those of qwen2's and phi3's bf16 prefill windows,
    # the TF32 kernel's those of qwen2's fp32 forward window (its route)
    stats.update(flash_phases(checks, device, cfg_q, net_q))
    mark("flash")
    del model_q, net_q
    torch.cuda.empty_cache()
    # qwen2-1.5b trained at full size (its serving net freed): no kernel launches
    t0 = time.perf_counter()
    train_lm("qwen2_1_5b", QWEN2_SIZE)
    print(f"train qwen2-1.5b phase: {time.perf_counter() - t0:.1f} s", flush=True)
    mark("train qwen2")
    phi3 = phi3_phases(checks, device)
    mark("phi3")
    stats["flash_attention_tc"]["launches"] += phi3["flash_attention_tc"]
    # phi3 (D=96) served through the paged kernel: its kernel route's launches
    stats["paged_attention"]["launches"] += phi3["paged_attention"]["launches"]
    print(f"time paged_attention decode read layer 0: qwen2-1.5b (D=128) "
          f"{stats['paged_attention']['ms']:.4f} ms, phi3-mini-3.8b (D=96) "
          f"{phi3['paged_attention']['ms']:.4f} ms", flush=True)
    # the MLA models served through the paged kernel's MLA instance: the
    # launches of their kernel routes' windows (and MiniCPM3's prefix cache)
    mla_read = {}
    for arch, params in (("deepseek_v2_lite_16b", DEEPSEEK_PARAMS),
                         ("minicpm3_4b", MINICPM3_PARAMS)):
        mla_read[arch] = mla_phase(checks, arch, params, device)
        stats["paged_attention"]["launches"] += mla_read[arch].pop("launches")
        mark(arch)
    stats["paged_attention"]["mla_read"] = mla_read
    # the ssm and hybrid families: RWKV-6 runs no kernel; Zamba2's shared
    # attention reads through the paged kernel (its kernel route's window)
    # and prefills through the flash kernel (its pallas window), at D=112
    rwkv_phase(checks, device)
    mark("rwkv6_3b")
    zamba = zamba_phase(checks, device)
    for name in ("paged_attention", "flash_attention_tc", "flash_attention"):
        stats[name]["launches"] += zamba[name].get("launches", 0)
        stats[name]["zamba_d112"] = zamba[name]
    mark("zamba2_7b")
    # the encoder-decoder, both encoder variants: its kernel-route windows'
    # launches (the flash kernel on both routes, the fused FLARE forward, and
    # the encode and decode under the pallas policy)
    seamless = seamless_phase(checks, device)
    print(f"seamless figures: {seamless.pop('figures')}", flush=True)
    for name, rec in seamless.items():
        stats[name]["launches"] += rec["launches"]
        stats[name]["seamless_m4t"] = rec
    mark("seamless_m4t_large_v2")
    # the encoder-decoder trained, both encoders: the FLARE fit's fused
    # forward and backward launches (row 4 in bf16 at D=64, with its records
    # at seamless-m4t's shape)
    fits = train_seamless_phase(checks, device)
    print(f"train seamless figures: {({mixer: run['figures'] for mixer, run in fits.items()})}",
          flush=True)
    for name, n in fits["flare"]["launches"].items():
        stats[name]["launches"] += n
    stats["flare_fused_bwd"]["seamless_m4t"] = {
        "bfloat16": fits["flare"]["bfloat16"], "float32": fits["flare"]["float32"],
        "launches": fits["flare"]["launches"]["flare_fused_bwd"]}
    mark("train_seamless_m4t_large_v2")
    print(f"train rwkv6 figures: {train_rwkv_phase(checks, device)}", flush=True)
    mark("train_rwkv6_3b")
    # the Table-1 mixers at flare_pde's width. The FLARE row's train steps
    # are a counted window of the fused forward and backward
    for name, n in pde_baselines(checks, cfg, device).items():
        stats[name]["launches"] += n
    torch.cuda.empty_cache()
    mark("pde baselines")
    for name in stats:
        stats[name]["max_abs_err"] = checks.max_abs[name]

    # beside each bound, the floors of a tensor-core design where it has them
    rows = [{"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
             **{key: stats[name][key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")},
             **{key: v for key, v in stats[name].items()
                if key.startswith("floor_") or key == "tuned"}}
            for name in REPLACES]
    # the paged kernel's row also carries its MLA instance's reads (bf16 pages),
    # the flash file's its bf16_mma route, the causal kernel's its fp32 route
    rows[list(REPLACES).index("paged_attention")]["mla_read"] = stats["paged_attention"]["mla_read"]
    stats["flash_attention"]["off_tma_bf16"]["max_abs_err"] = checks.max_abs["flash_bf16_mma"]
    rows[list(REPLACES).index("flash_attention")]["off_tma_bf16"] = \
        stats["flash_attention"]["off_tma_bf16"]
    stats["flare_causal_chunk"]["fp32"]["max_abs_err"] = checks.max_abs["flare_causal_chunk"]
    rows[list(REPLACES).index("flare_causal_chunk")]["fp32"] = stats["flare_causal_chunk"]["fp32"]
    # the paged and both flash rows carry their reads at Zamba2's D=112
    for name in ("paged_attention", "flash_attention_tc", "flash_attention"):
        rows[list(REPLACES).index(name)]["zamba_d112"] = stats[name]["zamba_d112"]
    # the flash rows and the FLARE forward's rows their seamless-m4t records
    for name in ("flash_attention_tc", "flash_attention", "flare_encode", "flare_decode",
                 "flare_fused_fwd", "flare_fused_bwd"):
        rows[list(REPLACES).index(name)]["seamless_m4t"] = stats[name]["seamless_m4t"]
    print(f"phase seconds: {marks}", flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
