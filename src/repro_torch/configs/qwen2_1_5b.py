"""qwen2-1.5b [dense]: 28 layers, d_model 1536, 12 heads with 2 KV heads
(GQA) of 128, SwiGLU FFN 8960, vocab 151,936; QKV bias, RoPE theta 1e6,
tied embeddings, RMSNorm. 1.54B parameters. [arXiv:2407.10671]
"""
from repro_torch.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        d_ff=8960,
        vocab=151936,
        attn=AttnConfig(kind="gqa", num_heads=12, num_kv_heads=2, head_dim=128,
                        rope_theta=1000000.0, qkv_bias=True),
        norm="rmsnorm",
        tie_embeddings=True,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        d_ff=128,
        vocab=128,
        attn=AttnConfig(kind="gqa", num_heads=6, num_kv_heads=2, head_dim=8, qkv_bias=True),
        norm="rmsnorm",
        tie_embeddings=True,
        remat="none",
    )
