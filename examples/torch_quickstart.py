"""Quickstart on the PyTorch port: build a FLARE surrogate, train it on
(CG-solved) Darcy data for a few dozen steps, and inspect the induced
low-rank operator. The port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --smoke

It runs on ``cuda`` unless ``--device cpu`` is given, and raises where there
is no CUDA device.
"""
import argparse

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.dispatch import MixerShape
from repro_torch.core.policy import MixerPolicy, resolve_policy
from repro_torch.core.spectral import effective_rank, spectrum_by_head
from repro_torch.data.pde_data import darcy_batch
from repro_torch.models import pde
from repro_torch.nn.modules import layernorm, resmlp
from repro_torch.optim.adamw import init_adamw
from repro_torch.train.steps import make_train_step

HEADS, LATENTS, BLOCKS, DIM = 4, 16, 2, 32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--grid", type=int, default=16, help="Darcy grid: N = grid**2 points")
    ap.add_argument("--smoke", action="store_true", help="6 steps on an 8x8 grid")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    steps, grid = (6, 8) if args.smoke else (args.steps, args.grid)
    print("== FLARE quickstart (PyTorch port) ==")
    # Plan-first dispatch: declare what the call needs (a differentiable
    # mixer, the best backend for the device) as a MixerPolicy, resolve it
    # once to a plan, and hand the plan to every call below.
    policy = MixerPolicy(backends=("auto",), requires_grad=True)
    plan = resolve_policy(policy, MixerShape(batch=4, heads=HEADS, tokens=grid * grid,
                                             latents=LATENTS, head_dim=DIM // HEADS),
                          torch.float32, device=dev.type)
    print(f"mixer policy {policy}\n  resolved once to plan: {plan.describe()}")

    print("generating Darcy data (coefficient field -> CG Poisson solve)...")
    train = [darcy_batch(0, i, 4, grid=grid, cg_iters=120, device=dev) for i in range(3)]
    test = darcy_batch(0, 50, 4, grid=grid, cg_iters=120, device=dev)

    net = pde.init_surrogate("flare", in_dim=3, out_dim=1, dim=DIM, num_blocks=BLOCKS,
                             num_heads=HEADS, num_latents=LATENTS,
                             generator=torch.Generator().manual_seed(0), device=dev)
    loss_fn = lambda n, b: pde.surrogate_loss(n, b, num_heads=HEADS, policy=plan)
    step = make_train_step(loss_fn, TrainConfig(steps=steps, learning_rate=2e-3,
                                                warmup_frac=0.0, weight_decay=0.0))
    opt = init_adamw(dict(net.named_parameters()))
    for i in range(steps):
        net, opt, metrics = step(net, opt, train[i % len(train)])
        if i % 20 == 0 or i == steps - 1:
            print(f"  step {i:3d}  train rel-L2 {float(metrics['loss']):.4f}")
    with torch.no_grad():
        held_out = float(loss_fn(net, test))
    print(f"held-out rel-L2: {held_out:.4f}  (1.0 == predict-zero baseline)")

    # the induced rank-<=M operator of block 0 (paper Fig. 12)
    block = net.blocks[0]
    with torch.no_grad():
        y = layernorm(block.ln1, resmlp(net.in_proj, test["x"]))
        k = resmlp(block.mixer.k_proj, y)[0].unflatten(-1, (HEADS, -1)).transpose(0, 1)
        vals = spectrum_by_head(block.mixer.q_latent, k).cpu()
    print("\nper-head spectra of W = W_dec @ W_enc (top 5 eigenvalues):")
    ranks = []
    for h in range(HEADS):
        ranks.append(int(effective_rank(vals[h])))
        top = ", ".join(f"{v:.3f}" for v in vals[h][:5].tolist())
        print(f"  head {h}: [{top}, ...]  effective rank (99%): {ranks[-1]}/{LATENTS}")
    return {"plan": plan.describe(), "loss": float(metrics["loss"]), "held_out": held_out,
            "ranks": ranks}


if __name__ == "__main__":
    main()
