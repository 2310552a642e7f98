"""phi3-mini-3.8b [dense]: 32 layers, d_model 3072, 32 heads of 96 with 32 KV
heads (MHA), SwiGLU FFN 8192, vocab 32,064; RoPE theta 1e4, no QKV bias, an
untied head, RMSNorm. 3.82B parameters. [arXiv:2404.14219]
"""
from repro_torch.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        d_ff=8192,
        vocab=32064,
        attn=AttnConfig(kind="gqa", num_heads=32, num_kv_heads=32, head_dim=96,
                        rope_theta=10000.0, qkv_bias=False),
        norm="rmsnorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        d_ff=256,
        vocab=128,
        attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=24),
        norm="rmsnorm",
        remat="none",
    )
