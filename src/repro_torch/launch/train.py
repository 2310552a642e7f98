"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Counterpart of ``repro/launch/train.py``. It trains on ``cuda`` unless
``--device cpu`` is given, and raises where there is no CUDA device rather
than falling back to the CPU. ``--smoke`` trains the reduced config of the
same family (CPU-runnable). Data, step-keyed, as the JAX launcher feeds it:
Darcy batches on a 16x16 grid for the pde family; ``TokenStream`` batches
of ``--seq-len`` tokens for the LMs (``flare_lm``, ``qwen2_1_5b``,
``phi3_mini_3_8b``), and for the encoder-decoder (``seamless_m4t_large_v2``)
beside them ``embeds``, standard normal source frames [B, seq_len,
d_model] in fp32 from ``np.random.default_rng(step)``, the arrays the JAX
launcher draws (its speech frontend is a stub)::

    python -m repro_torch.launch.train --arch flare_lm --smoke --device cpu --seq-len 32

``--mesh host`` trains sequence-parallel over every rank of the world, one
process a rank, as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; NCCL on CUDA, gloo with ``--device cpu``)::

    torchrun --nproc_per_node=1 -m repro_torch.launch.train --arch flare_pde \
        --mesh host --mixer packed_shard

``single`` and ``multi`` are the production meshes of 256 and 512 ranks.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pde_data import darcy_batch
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.api import get_model
from repro_torch.train.trainer import Trainer

GRID = 16   # the Darcy grid: N = GRID**2 points an example


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64, help="tokens a sequence (the LMs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--mesh", choices=["none", "host", "single", "multi"], default="none",
                    help="train sequence-parallel over the ranks of the world")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mixer", default=None,
                    help="FLARE mixer backend preference, comma-separated "
                         "(e.g. 'packed,sdpa', or 'packed_shard' with --mesh); default: auto")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-step train spans and write Chrome-trace-event JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the trainer's metrics registry as JSON here")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device, mesh, rank = args.device, None, 0
    if args.mesh != "none":
        from repro_torch.distributed.compat import init
        from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

        init(args.device)
        rank = torch.distributed.get_rank()
        if args.device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        mesh = (make_host_mesh(device_type=args.device) if args.mesh == "host" else
                make_production_mesh(multi_pod=args.mesh == "multi", device_type=args.device))
    policy = None
    if args.mixer:
        from repro_torch.core.policy import MixerPolicy

        policy = MixerPolicy(backends=tuple(args.mixer.split(",")))
    pde = cfg.family == "pde"
    model = get_model(cfg, policy=policy, device=device, mesh=mesh,
                      seq_len_hint=GRID * GRID if pde else args.seq_len)
    if rank == 0:
        print("mixer plans (resolved once at build): "
              + (" ".join(f"{k}={p.describe()}" for k, p in model.plans.items())
                 or "none (gqa attention: attn_sdpa impl=auto)"))

    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       checkpoint_every=max(10, args.steps // 4),
                       checkpoint_dir=args.ckpt, log_every=10)
    tracer = None
    if args.trace_out:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    trainer = Trainer(model, tcfg, mesh, num_microbatches=args.microbatches, tracer=tracer)
    if pde:
        batch_fn = lambda step: darcy_batch(0, step % 16, args.global_batch, grid=GRID,
                                            cg_iters=100, device=device)
    else:
        stream = TokenStream(cfg.vocab, args.seq_len, seed=tcfg.seed)

        def batch_fn(step):
            b = stream.global_batch(step, args.global_batch, 1)
            if cfg.family in ("encdec", "audio"):
                b["embeds"] = np.random.default_rng(step).standard_normal(
                    (args.global_batch, args.seq_len, cfg.d_model)).astype("float32")
            return b
    history = trainer.fit(batch_fn)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return
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
