"""minicpm3-4b [dense]: 62 layers, d_model 2560, 40 heads of MLA (q_lora
768, kv_lora 256, qk_nope 64, qk_rope 32, v 64), SwiGLU FFN 6400, vocab
73,448. 4.3B parameters. [hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.config import AttnConfig, MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        d_ff=6400,
        vocab=73448,
        attn=AttnConfig(
            kind="mla", num_heads=40, num_kv_heads=40, head_dim=64,
            rope_theta=10000.0,
            mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                          qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
        ),
        norm="rmsnorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab=128,
        attn=AttnConfig(
            kind="mla", num_heads=4, num_kv_heads=4, head_dim=16,
            mla=MLAConfig(kv_lora_rank=24, q_lora_rank=32,
                          qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        ),
        norm="rmsnorm",
        remat="none",
    )
