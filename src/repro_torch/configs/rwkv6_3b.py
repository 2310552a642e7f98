"""rwkv6-3b [ssm]: "Finch", 32 layers, d_model 2560 (40 heads of 64), channel
mix 8960, vocab 65,536; attention-free, a data-dependent per-channel decay.
3.10B parameters. [arXiv:2404.05892]
"""
from repro_torch.config import AttnConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        d_ff=8960,
        vocab=65536,
        attn=AttnConfig(kind="none"),
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64),
        norm="layernorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        d_ff=160,
        vocab=128,
        attn=AttnConfig(kind="none"),
        ssm=SSMConfig(kind="rwkv6", head_dim=16, chunk=8),
        norm="layernorm",
        remat="none",
    )
