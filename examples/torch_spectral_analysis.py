"""The paper's spectral analysis (Fig. 12, App. C) on the PyTorch port:
train FLARE on Darcy data, then eigendecompose every head's communication
operator W = W_dec @ W_enc with Algorithm 1 (``core/spectral.py``) and
print each block's decay profiles and effective ranks; last, Algorithm 1
against the dense O(N^3) eigendecomposition on one head. The port's
counterpart of ``examples/spectral_analysis.py``.

    PYTHONPATH=src python examples/torch_spectral_analysis.py
    PYTHONPATH=src python examples/torch_spectral_analysis.py --device cpu --smoke

It runs on ``cuda`` unless ``--device cpu`` is given, and raises where there
is no CUDA device.
"""
import argparse

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.flare import flare_block
from repro_torch.core.spectral import (effective_rank, flare_spectrum, flare_spectrum_dense,
                                       spectrum_by_head)
from repro_torch.data.pde_data import darcy_batch
from repro_torch.models import pde
from repro_torch.nn.modules import layernorm, resmlp
from repro_torch.optim.adamw import init_adamw
from repro_torch.train.steps import make_train_step

HEADS, LATENTS, BLOCKS, DIM = 4, 16, 3, 32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--smoke", action="store_true", help="4 steps on an 8x8 grid")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    steps, grid = (4, 8) if args.smoke else (args.steps, 16)
    train = [darcy_batch(0, i, 4, grid=grid, cg_iters=120, device=dev) for i in range(3)]
    net = pde.init_surrogate("flare", in_dim=3, out_dim=1, dim=DIM, num_blocks=BLOCKS,
                             num_heads=HEADS, num_latents=LATENTS,
                             generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(lambda n, b: pde.surrogate_loss(n, b, num_heads=HEADS),
                           TrainConfig(steps=steps, learning_rate=2e-3, warmup_frac=0.0,
                                       weight_decay=0.0))
    opt = init_adamw(dict(net.named_parameters()))
    for i in range(steps):
        net, opt, _ = step(net, opt, train[i % 3])

    # per-block, per-head spectra by Algorithm 1 (O(M^3 + M^2 N)), the first example
    heads = lambda t: t[0].unflatten(-1, (HEADS, -1)).transpose(0, 1)   # [H, N, D]
    ranks = []
    with torch.no_grad():
        x = resmlp(net.in_proj, train[0]["x"])
        print(f"spectra of W_h = W_dec @ W_enc, M={LATENTS} latents, {HEADS} heads")
        h_states = x
        for bi, block in enumerate(net.blocks):
            k = heads(resmlp(block.mixer.k_proj, layernorm(block.ln1, h_states)))
            vals = spectrum_by_head(block.mixer.q_latent, k).cpu()
            print(f"\nblock {bi}:")
            ranks.append([])
            for h in range(HEADS):
                ranks[-1].append(int(effective_rank(vals[h])))
                bar = "#" * max(1, int(20 * vals[h][1] / max(float(vals[h][0]), 1e-9)))
                top = ", ".join(f"{v:.3f}" for v in vals[h][:5].tolist())
                print(f"  head {h}: top5 = [{top}]  eff.rank(99%) = {ranks[-1][-1]:2d}/"
                      f"{LATENTS}  decay {bar}")
            h_states = flare_block(block, h_states)   # the residual stream through the block

        # Algorithm 1 against the dense O(N^3) oracle on one head
        block = net.blocks[0]
        k = heads(resmlp(block.mixer.k_proj, layernorm(block.ln1, x)))
        fast, _ = flare_spectrum(block.mixer.q_latent[0], k[0])
        dense, _ = flare_spectrum_dense(block.mixer.q_latent[0], k[0])
        err = float((fast - dense[:LATENTS]).abs().max())
    print(f"\nAlgorithm 1 vs dense eigendecomposition: max|diff| = {err:.2e}")
    return {"ranks": ranks, "dense_err": err}


if __name__ == "__main__":
    main()
