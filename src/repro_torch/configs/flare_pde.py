"""flare-pde [paper-native]: the paper's PDE surrogate at DrivAerML-1M
scale (App. E): 8 FLARE blocks, C=64 features, H=8 heads (D=8), M=2048
latents. Shapes: pde_40k / pde_1m (``repro_torch.config.SHAPES``).
"""
from repro_torch.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flare-pde",
        family="pde",
        num_layers=8,          # B blocks
        d_model=64,            # C
        d_ff=64,
        vocab=0,
        attn=AttnConfig(kind="none"),
        flare_heads=8,
        flare_latents=2048,
        norm="layernorm",
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="flare-pde-smoke",
        family="pde",
        num_layers=2,
        d_model=32,
        d_ff=32,
        vocab=0,
        attn=AttnConfig(kind="none"),
        flare_heads=4,
        flare_latents=16,
        norm="layernorm",
        remat="none",
    )
