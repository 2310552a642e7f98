"""zamba2-7b [hybrid]: 81 layers, d_model 3584, a Mamba2 backbone (state 64,
expand 2 -> d_inner 7168, 112 heads of 64) and one SHARED attention block
(32 heads, 32 KV heads of 112, SwiGLU FFN 14,336) applied every 6th layer
with per-invocation LoRA (rank 128); vocab 32,000. 5.83B parameters.
[arXiv:2411.15242]

As in the JAX package: one shared block instead of the release's two
alternating ones, and LoRA on the q, k, v and MLP-gate projections.
"""
from repro_torch.config import AttnConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        d_ff=14336,
        vocab=32000,
        attn=AttnConfig(kind="gqa", num_heads=32, num_kv_heads=32, head_dim=112,
                        rope_theta=10000.0),
        ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                      conv_kernel=4, chunk=64),
        shared_attn_every=6,
        lora_rank=128,
        norm="rmsnorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=7,
        d_model=64,
        d_ff=128,
        vocab=128,
        attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16),
        ssm=SSMConfig(kind="mamba2", state_dim=16, head_dim=16, expand=2,
                      conv_kernel=4, chunk=8),
        shared_attn_every=3,
        lora_rank=8,
        norm="rmsnorm",
        remat="none",
    )
