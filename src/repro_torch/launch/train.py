"""Training launcher: ``python -m repro_torch.launch.train --arch flare_pde [--smoke]``.

Counterpart of ``repro/launch/train.py`` on one device. It trains on
``cuda`` unless ``--device cpu`` is given, and raises where there is no
CUDA device rather than falling back to the CPU. ``--smoke`` trains the
reduced config of the same family (CPU-runnable). Data: Darcy batches on a
16x16 grid, step-keyed, as the JAX launcher feeds the pde family.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pde_data import darcy_batch
from repro_torch.models.api import get_model
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mixer", default=None,
                    help="FLARE mixer backend preference, comma-separated "
                         "(e.g. 'packed,sdpa'); default: auto")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-step train spans and write Chrome-trace-event JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the trainer's metrics registry as JSON here")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = None
    if args.mixer:
        from repro_torch.core.policy import MixerPolicy

        policy = MixerPolicy(backends=tuple(args.mixer.split(",")))
    model = get_model(cfg, policy=policy, device=args.device)
    print(f"mixer plans (resolved once at build): train={model.plans['train'].describe()} "
          f"infer={model.plans['infer'].describe()}")

    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       checkpoint_every=max(10, args.steps // 4),
                       checkpoint_dir=args.ckpt, log_every=10)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    trainer = Trainer(model, tcfg, num_microbatches=args.microbatches, tracer=tracer)
    history = trainer.fit(lambda step: darcy_batch(0, step % 16, args.global_batch, grid=16,
                                                   cg_iters=100, device=args.device))
    if history:
        print(f"\n{cfg.name}: {len(history)} steps, "
              f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    if args.trace_out:
        print(f"trace: {trainer.tracer.write(args.trace_out)} spans -> {args.trace_out}")
    if args.metrics_out:
        trainer.metrics.dump_json(args.metrics_out)
        print(f"metrics: {len(trainer.metrics.snapshot())} series -> {args.metrics_out}")


if __name__ == "__main__":
    main()
