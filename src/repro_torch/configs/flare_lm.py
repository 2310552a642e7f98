"""flare-lm [paper-native, beyond-paper variant]: a ~2.6B decoder-only LM
whose token mixer is causal, streaming FLARE (``core/flare_stream.py``).

24 layers, d_model=2048, 16 heads x 128, M=512 latents per head, SwiGLU FFN
8192, vocab 65536, RMSNorm. The decode state is O(M x D) per layer and head,
constant in sequence length. Shapes: train_4k / prefill_32k / decode_32k /
long_500k (``repro_torch.config.SHAPES``).
"""
from repro_torch.config import AttnConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="flare-lm",
        family="flare_lm",
        num_layers=24,
        d_model=2048,
        d_ff=8192,
        vocab=65536,
        attn=AttnConfig(kind="flare_stream", num_heads=16, num_kv_heads=16,
                        head_dim=128, flare_latents=512, flare_chunk=1024),
        norm="rmsnorm",
        tie_embeddings=False,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="flare-lm-smoke",
        family="flare_lm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab=128,
        attn=AttnConfig(kind="flare_stream", num_heads=4, num_kv_heads=4,
                        head_dim=16, flare_latents=8, flare_chunk=8),
        norm="rmsnorm",
        remat="none",
    )
