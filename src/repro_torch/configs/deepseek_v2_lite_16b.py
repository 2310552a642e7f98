"""deepseek-v2-lite-16b [moe]: 27 layers, d_model 2048, 16 heads of MLA
(kv_lora 512, full-rank queries, qk_nope 128, qk_rope 64, v 128), 64 routed
experts top-6 of FFN 1408 and 2 shared (FFN 2816), the first layer dense
(FFN 10944), vocab 102,400. 15.7B parameters. [arXiv:2405.04434]

As in the JAX package, ``norm_topk_prob=False`` takes the Mixtral routing
branch (top-k of the logits, softmax over the selected), not DeepSeek's
published one.
"""
from repro_torch.config import AttnConfig, MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        d_ff=10944,  # the leading dense layer's FFN
        vocab=102400,
        attn=AttnConfig(
            kind="mla", num_heads=16, num_kv_heads=16, head_dim=128,
            rope_theta=10000.0,
            mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                          qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        ),
        moe=MoEConfig(
            num_experts=64, top_k=6, num_shared=2, expert_ffn=1408,
            shared_ffn=2816, capacity_factor=1.25, norm_topk_prob=False,
            routed_scale=1.0, first_dense_layers=1,
        ),
        norm="rmsnorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        d_ff=160,
        vocab=128,
        attn=AttnConfig(
            kind="mla", num_heads=4, num_kv_heads=4, head_dim=16,
            mla=MLAConfig(kv_lora_rank=32, q_lora_rank=None,
                          qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        ),
        moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, expert_ffn=32,
                      shared_ffn=64, capacity_factor=2.0, norm_topk_prob=False,
                      first_dense_layers=1),
        norm="rmsnorm",
        remat="none",
    )
