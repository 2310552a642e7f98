"""seamless-m4t-large-v2 [audio]: an encoder-decoder, 24 encoder and 24
decoder layers, d_model 1024, 16 heads (16 KV heads) of 64, SwiGLU FFN
8192, vocab 256,206 (256,256 rows padded), layernorms and biased q/k/v.
The speech/text frontend is a stub: the encoder takes precomputed frame
embeddings. 2,035,232,768 parameters; 2,217,881,600 with the FLARE
encoder. [arXiv:2308.11596]

The encoder is bidirectional, so the paper's FLARE block applies to it as
the paper means it: ``config("flare")`` (name ``seamless-m4t-large-v2-flare``)
mixes each encoder layer with FLARE (16 heads, 256 latents) instead of
attention.
"""
from repro_torch.config import AttnConfig, ModelConfig


def config(encoder_mixer: str = "attn") -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2" + ("-flare" if encoder_mixer == "flare" else ""),
        family="audio",
        num_layers=24,
        num_encoder_layers=24,
        d_model=1024,
        d_ff=8192,
        vocab=256206,
        attn=AttnConfig(kind="gqa", num_heads=16, num_kv_heads=16, head_dim=64,
                        rope_theta=10000.0, qkv_bias=True),
        norm="layernorm",
        tie_embeddings=False,
        encoder_mixer=encoder_mixer,
        flare_latents=256,
        flare_heads=16,
        remat="full",
        microbatch=1,
    )


def smoke_config(encoder_mixer: str = "attn") -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="audio",
        num_layers=2,
        num_encoder_layers=2,
        d_model=64,
        d_ff=128,
        vocab=128,
        attn=AttnConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16, qkv_bias=True),
        norm="layernorm",
        encoder_mixer=encoder_mixer,
        flare_latents=16,
        flare_heads=4,
        remat="none",
    )
