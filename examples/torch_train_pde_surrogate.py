"""End-to-end training on the PyTorch port: the paper's FLARE surrogate on
Darcy data through ``get_model`` and ``Trainer`` (checkpoints through the
checkpoint manager, restart-safe data, OneCycle AdamW). The port's
counterpart of ``examples/train_pde_surrogate.py``.

    PYTHONPATH=src python examples/torch_train_pde_surrogate.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_pde_surrogate.py --device cpu --smoke

It trains on ``cuda`` unless ``--device cpu`` is given, and raises where
there is no CUDA device. Run it again with the same ``--ckpt`` to resume
from the last checkpoint.
"""
import argparse
import logging
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import AttnConfig, ModelConfig, TrainConfig
from repro_torch.core.policy import MixerPolicy
from repro_torch.data.pde_data import darcy_batch
from repro_torch.models.api import get_model
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--latents", type=int, default=16)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "flare_pde_ckpt_torch"))
    ap.add_argument("--fresh", action="store_true", help="ignore old checkpoints")
    ap.add_argument("--smoke", action="store_true", help="8 steps on an 8x8 grid")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    steps, grid = (8, 8) if args.smoke else (args.steps, args.grid)
    if args.fresh:
        shutil.rmtree(args.ckpt, ignore_errors=True)

    cfg = ModelConfig(name="flare-pde-example", family="pde", num_layers=args.blocks,
                      d_model=args.dim, d_ff=args.dim, vocab=0, attn=AttnConfig(kind="none"),
                      flare_heads=args.heads, flare_latents=args.latents, norm="layernorm",
                      remat="none")
    # Plan-first dispatch: the policy resolves once inside get_model (the
    # loss plan grad-capable); the Trainer's step runs the resolved plan.
    model = get_model(cfg, policy=MixerPolicy(backends=("auto",)), device=args.device,
                      seq_len_hint=grid * grid)
    print(f"mixer plans (resolved once at build): train={model.plans['train'].describe()} "
          f"infer={model.plans['infer'].describe()}")
    tcfg = TrainConfig(steps=steps, learning_rate=2e-3, warmup_frac=0.1,
                       checkpoint_every=max(2, steps // 4), checkpoint_dir=args.ckpt,
                       log_every=max(1, steps // 10))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    trainer = Trainer(model, tcfg)
    # deterministic, restart-safe data: the batch is a function of the step
    batch_fn = lambda step: darcy_batch(0, step % 16, args.batch, grid=grid, cg_iters=120,
                                        device=args.device)
    history = trainer.fit(batch_fn)
    if history:
        print(f"\ntrained {len(history)} steps: rel-L2 {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f}")
    test = darcy_batch(0, 99, args.batch, grid=grid, cg_iters=120, device=args.device)
    with torch.no_grad():
        err = float(model.loss(trainer.net, test))
    print(f"held-out rel-L2: {err:.4f}")
    latest = CheckpointManager(args.ckpt).latest_step()
    print(f"checkpoints in {args.ckpt}, latest step {latest} (run again to resume)")
    return {"history": history, "held_out": err, "latest_step": latest}


if __name__ == "__main__":
    main()
