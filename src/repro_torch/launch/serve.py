"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2_1_5b [--smoke]``.

Counterpart of ``repro/launch/serve.py`` on one device. The requests are
drawn from ``--seed`` up front: independent prompts of ``--prompt-len // 2
+ 1`` to ``--prompt-len`` tokens, or, with ``--share-prefix N``, the
multi-tenant shape: every prompt is one of N ``--prompt-len`` templates
plus a short random tail (request 0 is the exact first template), drawn the
same way whether the prefix cache is on or off, so the two runs see the
same prompts. ``--rate`` submits them as an open-loop Poisson stream (0: all
up front). It serves on ``cuda`` unless ``--device cpu`` is given, and
raises where there is no CUDA device rather than falling back to the CPU.
The weights are random, drawn on that device from ``--seed`` (every
registered LM: ``--arch qwen2_1_5b``, ``phi3_mini_3_8b``, ``flare_lm``,
``minicpm3_4b``, ``deepseek_v2_lite_16b``, ``rwkv6_3b``, ``zamba2_7b``);
``--smoke`` serves the reduced
config of the same family. Prints the generated tokens, tok/s, latency
percentiles, the resolved decode backend and, for the paged pool
(``--pool-tokens``), the pool's and the prefix cache's stats;
``--trace-out`` writes the engine's spans as Chrome-trace JSON and
``--metrics-out`` its metrics registry as JSON. ``--warmup`` runs
``ServeEngine.warmup`` before serving (every prefill bucket, then the decode
step captured as one CUDA graph; on the CPU the step is built without a
capture); ``--max-decode-compiles N`` exits non-zero when the serving loop
built the decode step more than N times; ``--no-cuda-graph`` serves on the
eager decode step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine


def workload(rng: np.random.Generator, vocab: int, requests: int, prompt_len: int,
             share_prefix: int):
    """(prompts, templates): the launcher's request prompts, and the shared
    templates when ``share_prefix`` > 0 (else an empty list)."""
    if share_prefix > 0:
        templates = [rng.integers(0, vocab, prompt_len) for _ in range(share_prefix)]
        tails = rng.integers(1, 5, requests)
        prompts = [templates[0].copy() if i == 0 else
                   np.concatenate([templates[i % share_prefix],
                                   rng.integers(0, vocab, int(tails[i]))])
                   for i in range(requests)]
        return prompts, templates
    return [rng.integers(0, vocab, max(1, int(n)))
            for n in rng.integers(prompt_len // 2 + 1, prompt_len + 1, requests)], []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in requests/s (0: submit all "
                         "requests up front)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (a request still queued then is "
                         "dropped at admission)")
    ap.add_argument("--pool-tokens", type=int, default=None,
                    help="total pooled KV tokens: the block-paged pool, whose admission is "
                         "bounded by tokens, not slots")
    ap.add_argument("--block-size", type=int, default=16, help="paged-pool block in tokens")
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8", "fp8"),
                    help="paged-pool storage quantization (dequantized on read)")
    ap.add_argument("--decode-backend", default="auto", choices=("auto", "paged", "gather"),
                    help="paged-pool decode read: the paged-attention kernel ('paged'), a "
                         "dense gather ('gather'), or policy resolution ('auto')")
    ap.add_argument("--coalesce", action="store_true",
                    help="batch same-bucket admissions into one prefill (lanes are then held "
                         "within a tolerance of a solo run, not bitwise)")
    ap.add_argument("--mixer", default=None,
                    help="FLARE mixer backend preference, comma-separated (e.g. "
                         "'causal_pallas,causal_stream'); default: auto")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share the blocks of common prompt prefixes across requests "
                         "(needs --pool-tokens and a gqa or mla arch; off otherwise)")
    ap.add_argument("--pin-prompt", action="store_true",
                    help="pin the shared templates' blocks before serving (prefilled by a "
                         "one-token request); needs --share-prefix")
    ap.add_argument("--share-prefix", type=int, default=0,
                    help="N > 0: every prompt is one of N --prompt-len templates plus a tail "
                         "of 1-4 random tokens; request 0 is the exact first template")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the engine's request-lifecycle spans here as Chrome-trace "
                         "JSON (host-side only: no host sync added, tokens unchanged)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the engine's metrics registry here as JSON at exit")
    ap.add_argument("--sample", default="greedy", choices=("greedy", "topk"),
                    help="on-device sampler (greedy argmax, or top-k with temperature)")
    ap.add_argument("--top-k", type=int, default=0, help="k for --sample topk")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--warmup", action="store_true",
                    help="pre-compile every (bucket, lanes) prefill and the fused decode step "
                         "before serving, so steady state never recompiles")
    ap.add_argument("--max-decode-compiles", type=int, default=None,
                    help="exit nonzero if the serving loop compiled the decode step more than "
                         "this many times (warmup compiles excluded)")
    ap.add_argument("--no-cuda-graph", action="store_true",
                    help="run the eager decode step (the CUDA-graph route's oracle) instead of "
                         "one captured graph a step")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the CPU")
    if args.pin_prompt and args.share_prefix <= 0:
        raise SystemExit("--pin-prompt needs --share-prefix")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = None
    if args.mixer:
        from repro_torch.core.policy import MixerPolicy

        policy = MixerPolicy(backends=tuple(args.mixer.split(",")))
    model = get_model(cfg, policy=policy, device=args.device, seq_len_hint=args.capacity)
    if model.prefill_into is None:
        raise SystemExit(f"{cfg.name} has no slot-pool serving path (family={cfg.family})")
    if model.plans:
        print(f"mixer plan (resolved once at build): infer={model.plans['infer'].describe()}")
    # drawn on the serving device (a 15.7B draw on the host takes minutes)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    net = model.init(args.seed, generator=gen)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    engine = ServeEngine(model, net, capacity=args.capacity, slots=args.slots,
                         temperature=args.temperature, seed=args.seed,
                         pool_tokens=args.pool_tokens, kv_quant=args.kv_quant,
                         block_size=args.block_size, coalesce_prefill=args.coalesce,
                         sample=args.sample, top_k=args.top_k,
                         decode_backend=args.decode_backend, prefix_cache=args.prefix_cache,
                         tracer=tracer, cuda_graph=not args.no_cuda_graph)
    print(f"engine: {args.slots} slots, capacity {args.capacity}, {engine.stats['cache']}")
    print(f"decode backend: {engine.stats['decode_backend']}  sampler: {args.sample}"
          + (f"(k={args.top_k})" if args.sample == "topk" else ""))
    if args.warmup:
        n = engine.warmup(max_prompt_len=args.prompt_len)
        print(f"warmup: {n} programs compiled in {engine.stats['warmup_s']:.2f}s")
    warm_decode_compiles = engine.stats["decode_compiles"]

    rng = np.random.default_rng(args.seed)
    prompts, templates = workload(rng, cfg.vocab, args.requests, args.prompt_len,
                                  args.share_prefix)
    arrivals = (np.zeros(args.requests) if args.rate <= 0
                else np.cumsum(rng.exponential(1.0 / args.rate, args.requests)))
    if args.pin_prompt:
        print(f"pinned {sum(engine.pin_prefix(t) for t in templates)} template blocks")

    t0 = time.time()
    submitted = 0
    traffic: list = []   # the requests' ids (a pin's one-token probe is not one)
    while submitted < args.requests or engine.sched.has_work():
        now = time.time() - t0
        while submitted < args.requests and arrivals[submitted] <= now:
            traffic.append(engine.submit(prompts[submitted], max_new_tokens=args.max_new,
                                         deadline_s=args.deadline))
            submitted += 1
        if not engine.step() and submitted < args.requests:
            # open loop: wait for the next arrival
            time.sleep(max(0.0, arrivals[submitted] - (time.time() - t0)))
    dt = time.time() - t0
    done = {r.rid: r.tokens for r in engine.sched.finished + engine.sched.dropped}
    for i, rid in enumerate(traffic):
        print(f"req {i}: {done[rid]}")

    s = engine.stats
    print(f"\n{s['requests']} requests / {s['tokens_generated']} tokens in {dt:.2f}s "
          f"({s['tokens_generated'] / dt:.1f} tok/s; prefill {s['prefill_s']:.2f}s, decode "
          f"{s['decode_s']:.2f}s over {s['decode_steps']} steps) on {args.device}")
    print(f"latency p50/p99: {s['latency_p50_s'] * 1e3:.1f}/{s['latency_p99_s'] * 1e3:.1f} ms  "
          f"first-token p50/p99: {s['first_token_p50_s'] * 1e3:.1f}/"
          f"{s['first_token_p99_s'] * 1e3:.1f} ms")
    print(f"slot utilization {s['slot_utilization']:.2f}, admitted peak "
          f"{s['admitted_peak']}/{args.slots}, {s['coalesced_prefills']} coalesced prefills, "
          f"{s['dropped']} dropped, host syncs/step {s['host_syncs_per_step']:.1f}")
    print(f"decode backend: {s['decode_backend']}")
    serve_compiles = s["decode_compiles"] - warm_decode_compiles
    print(f"decode compiles: {s['decode_compiles']} total, {serve_compiles} while serving; "
          f"warmup: {s['warmup_compiles']} programs ({s['warmup_s']:.2f}s); host syncs/step: "
          f"{s['host_syncs_per_step']:.1f}")
    if args.max_decode_compiles is not None and serve_compiles > args.max_decode_compiles:
        raise SystemExit(f"decode step compiled {serve_compiles}x while serving (bound "
                         f"{args.max_decode_compiles}) — the steady-state loop is retracing")
    if engine.paged:
        p = s["pool"]
        print(f"paged pool: {p['blocks_mapped']}/{p['blocks_total']} blocks mapped (peak "
              f"{p['blocks_peak_mapped']}), {p['pages_appended']} pages appended at block "
              f"boundaries, {p['blocks_free']} free after the run")
        print(f"prefix cache: enabled={s['prefix_cache']} hit_rate={s['prefix_hit_rate']:.3f} "
              f"shared_pages={s['shared_pages']} cow_copies={s['cow_copies']} "
              f"pinned={s['pinned_pages']}")
    if args.trace_out:
        print(f"trace: {engine.tracer.write(args.trace_out)} spans -> {args.trace_out}")
    if args.metrics_out:
        engine.metrics.dump_json(args.metrics_out)
        print(f"metrics: {len(engine.metrics.snapshot())} series -> {args.metrics_out}")


if __name__ == "__main__":
    main()
