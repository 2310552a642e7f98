"""Serve a small FLARE-LM (causal, streaming FLARE decoder) on the PyTorch
port with batched requests: quick-train it on the synthetic Markov stream
so that generations have structure, then run ``ServeEngine`` (prefill and
step decode over a slot pool). The port's counterpart of
``examples/serve_llm.py``.

    PYTHONPATH=src python examples/torch_serve_llm.py
    PYTHONPATH=src python examples/torch_serve_llm.py --device cpu --smoke

It runs on ``cuda`` unless ``--device cpu`` is given, and raises where there
is no CUDA device.
"""
import argparse
import time

import torch

from repro_torch.config import AttnConfig, ModelConfig, TrainConfig
from repro_torch.core.policy import MixerPolicy
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import init_adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.steps import make_train_step

VOCAB = 128


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--smoke", action="store_true", help="10 train steps, shorter requests")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    train_steps, new_tokens = (10, 2) if args.smoke else (args.train_steps, 8)
    cfg = ModelConfig(name="flare-lm-serve", family="flare_lm", num_layers=2, d_model=64,
                      d_ff=128, vocab=VOCAB,
                      attn=AttnConfig(kind="flare_stream", num_heads=4, num_kv_heads=4,
                                      head_dim=16, flare_latents=8, flare_chunk=8),
                      remat="none")
    # Plan-first dispatch: the policy is resolved once inside get_model;
    # training and serving below run the resolved plans.
    model = get_model(cfg, policy=MixerPolicy(backends=("auto",)), device=args.device,
                      seq_len_hint=128)
    print(f"mixer plans (resolved once at build): train={model.plans['train'].describe()} "
          f"infer={model.plans['infer'].describe()}")
    net = model.init(0)

    print("quick-training on the Markov stream (so that decoding shows structure)...")
    stream = TokenStream(VOCAB, 32, seed=0)
    step = make_train_step(model.loss, TrainConfig(steps=train_steps, learning_rate=3e-3))
    opt = init_adamw(dict(net.named_parameters()))
    for i in range(train_steps):
        batch = {k: torch.as_tensor(v, device=args.device)
                 for k, v in stream.batch(i, 0, 1, 8).items()}
        net, opt, metrics = step(net, opt, batch)
    print(f"  final train loss: {float(metrics['loss']):.3f}")

    # continuous batching: 4 persistent slots; staggered max_new_tokens, so
    # retired slots hand over to queued requests mid-flight
    engine = ServeEngine(model, net, capacity=128, slots=4, temperature=0.0)
    prompts = [stream.batch(1000 + i, 0, 1, 1)["tokens"][0, :12] for i in range(5)]
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=new_tokens + 4 * i)
    t0 = time.time()
    outs = engine.run_all()
    dt = time.time() - t0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"req {i}: prompt={p.tolist()[:8]}... -> generated={list(map(int, o))}")
    s = engine.stats
    print(f"\n{s['requests']} requests, {s['tokens_generated']} tokens in {dt:.2f}s "
          f"(prefill {s['prefill_s']:.2f}s, decode {s['decode_s']:.2f}s over "
          f"{s['decode_steps']} steps, slot utilization {s['slot_utilization']:.2f}); "
          f"the build-time plan: {model.plans['infer'].describe()}")
    print("the FLARE decode state is O(M x D) a layer: constant in context length.")
    return {"outs": [list(map(int, o)) for o in outs], "stats": dict(s),
            "loss": float(metrics["loss"])}


if __name__ == "__main__":
    main()
