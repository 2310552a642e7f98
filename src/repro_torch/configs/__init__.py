"""Architecture registry of the port: ``get_config(name)`` resolves here.

Each module exports ``config()`` (the assigned configuration) and
``smoke_config()`` (a reduced configuration of the same family for CPU
tests). The port has the PDE surrogate, the causal FLARE LM, the gqa
decoders qwen2-1.5b and phi3-mini-3.8b, the MLA decoder minicpm3-4b, the
MLA + MoE decoder deepseek-v2-lite-16b, the RWKV-6 LM rwkv6-3b, the
Mamba2 + shared-attention hybrid zamba2-7b and the encoder-decoder
seamless-m4t-large-v2 (whose ``config("flare")`` gives the FLARE encoder)
so far.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["deepseek_v2_lite_16b", "flare_lm", "flare_pde", "minicpm3_4b", "phi3_mini_3_8b",
            "qwen2_1_5b", "rwkv6_3b", "seamless_m4t_large_v2", "zamba2_7b"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
