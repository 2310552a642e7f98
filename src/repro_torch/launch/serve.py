"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2_1_5b [--smoke]``.

Counterpart of ``repro/launch/serve.py`` on one device, closed-loop: the
requests (seeded prompts of ``--prompt-len // 2 + 1`` to ``--prompt-len``
tokens) are all submitted up front and the continuous-batching engine
drains them. It serves on ``cuda`` unless ``--device cpu`` is given, and
raises where there is no CUDA device rather than falling back to the CPU.
``--smoke`` serves the reduced config of the same family with random
weights from ``--seed``. Prints the generated tokens, tok/s, latency
percentiles, the resolved decode backend and, for the paged pool
(``--pool-tokens``), the pool's stats.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine


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
    ap.add_argument("--pool-tokens", type=int, default=None,
                    help="total pooled KV tokens: the block-paged pool, whose admission is "
                         "bounded by tokens, not slots")
    ap.add_argument("--block-size", type=int, default=16, help="paged-pool block in tokens")
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8", "fp8"),
                    help="paged-pool storage quantization (dequantized on read)")
    ap.add_argument("--decode-backend", default="auto", choices=("auto", "paged", "gather"),
                    help="paged-pool decode read: the paged-attention kernel ('paged'), a "
                         "dense gather ('gather'), or policy resolution ('auto')")
    ap.add_argument("--sample", default="greedy", choices=("greedy", "topk"),
                    help="on-device sampler (greedy argmax, or top-k with temperature)")
    ap.add_argument("--top-k", type=int, default=0, help="k for --sample topk")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the CPU")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg, device=args.device)
    if model.prefill_into is None:
        raise SystemExit(f"{cfg.name} has no slot-pool serving path (family={cfg.family})")
    if model.plans:
        print(f"mixer plan (resolved once at build): infer={model.plans['infer'].describe()}")
    net = model.init(args.seed)
    engine = ServeEngine(model, net, capacity=args.capacity, slots=args.slots,
                         temperature=args.temperature, seed=args.seed,
                         pool_tokens=args.pool_tokens, kv_quant=args.kv_quant,
                         block_size=args.block_size, sample=args.sample, top_k=args.top_k,
                         decode_backend=args.decode_backend)
    print(f"engine: {args.slots} slots, capacity {args.capacity}, {engine.stats['cache']}")
    print(f"decode backend: {engine.stats['decode_backend']}  sampler: {args.sample}"
          + (f"(k={args.top_k})" if args.sample == "topk" else ""))

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(args.prompt_len // 2 + 1, args.prompt_len + 1, args.requests)]
    t0 = time.time()
    for prompt in prompts:
        engine.submit(prompt, max_new_tokens=args.max_new)
    outs = engine.run_all()
    dt = time.time() - t0
    for i, out in enumerate(outs):
        print(f"req {i}: {out.tolist()}")

    s = engine.stats
    print(f"\n{s['requests']} requests / {s['tokens_generated']} tokens in {dt:.2f}s "
          f"({s['tokens_generated'] / dt:.1f} tok/s; prefill {s['prefill_s']:.2f}s, decode "
          f"{s['decode_s']:.2f}s over {s['decode_steps']} steps) on {args.device}")
    print(f"latency p50/p99: {s['latency_p50_s'] * 1e3:.1f}/{s['latency_p99_s'] * 1e3:.1f} ms  "
          f"first-token p50/p99: {s['first_token_p50_s'] * 1e3:.1f}/"
          f"{s['first_token_p99_s'] * 1e3:.1f} ms")
    print(f"slot utilization {s['slot_utilization']:.2f}, admitted peak "
          f"{s['admitted_peak']}/{args.slots}, {s['dropped']} dropped, host syncs/step "
          f"{s['host_syncs_per_step']:.1f}")
    print(f"decode backend: {s['decode_backend']}")
    if engine.paged:
        p = s["pool"]
        print(f"paged pool: {p['blocks_mapped']}/{p['blocks_total']} blocks mapped (peak "
              f"{p['blocks_peak_mapped']}), {p['pages_appended']} pages appended at block "
              f"boundaries, {p['blocks_free']} free after the run")


if __name__ == "__main__":
    main()
