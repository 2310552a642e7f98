"""Model, shape and training configuration for the port.

The port's own copy of the fields of ``repro.config.ModelConfig``,
``AttnConfig``, ``MLAConfig``, ``MoEConfig`` and ``SSMConfig`` that the
PDE family, the causal FLARE LM (``flare_lm``), the gqa and MLA decoders
(the ``dense`` family, e.g. qwen2 and minicpm3), the MoE decoder (the
``moe`` family, deepseek-v2-lite), RWKV-6 (the ``ssm`` family), the
Mamba2 + shared-attention hybrid (the ``hybrid`` family, zamba2) and the
encoder-decoder (the ``encdec`` / ``audio`` family, seamless-m4t-large-v2,
whose encoder is attention or FLARE) read, of their shapes, and of the
``TrainConfig`` fields the trainer reads (the mesh's gradient compression
is not ported). ``param_dtype`` and
``compute_dtype`` mean what they mean in the JAX package: parameters are
stored in the first and cast to the second at use. The PDE family computes
in fp32 whatever ``compute_dtype`` says, as ``models/api.py`` of the JAX
package forces; the LMs and the encoder-decoder (its FLARE encoder too)
compute in ``compute_dtype`` (bf16 by default).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention compression."""
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None  # None => full-rank queries
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttnConfig:
    """The fields the gqa and MLA attention and the ``flare_stream`` mixer read."""
    kind: str = "gqa"               # gqa | mla | flare_stream | none (the ssm family)
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # tokens; None => full attention
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    mla: Optional[MLAConfig] = None
    flare_latents: int = 0          # M latents per head
    flare_chunk: int = 256          # tokens per chunk of the causal scan

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared: int = 0
    expert_ffn: int = 1408          # per-expert hidden size
    shared_ffn: int = 0             # hidden size of the shared expert(s)
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True     # renormalize gates over the selected k
    routed_scale: float = 1.0       # deepseek routed_scaling_factor
    first_dense_layers: int = 0     # leading layers that use a dense FFN


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"            # mamba2 | rwkv6
    state_dim: int = 64             # N (mamba2) / head_dim (rwkv6 keys)
    head_dim: int = 64
    num_heads: int = 0              # 0 => derived from d_inner / head_dim
    expand: int = 2                 # d_inner = expand * d_model
    conv_kernel: int = 4            # mamba2 depthwise conv width
    chunk: int = 64                 # chunked-scan block length
    dt_rank: int = 0                # unused by mamba2 (scalar dt per head)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "pde"             # pde | flare_lm | dense | moe | ssm | hybrid | encdec | audio
    num_layers: int = 4             # FLARE blocks (pde) or decoder layers (the LMs, encdec)
    d_model: int = 256              # C
    # M and H of the FLARE mixer: the pde family's blocks, and the encdec
    # family's FLARE encoder layers (0 there: 256 latents, attn.num_heads
    # heads); head dim D = d_model // H
    flare_latents: int = 0
    flare_heads: int = 0
    # the LMs (flare_lm, dense, moe, ssm, hybrid) and the encdec decoder
    d_ff: int = 1024                # the SwiGLU FFN (moe: its leading dense layers'; ssm:
                                    # the channel mix's; hybrid: the shared block's)
    vocab: int = 32000
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"           # rmsnorm | layernorm (the ssm family's are layernorms)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # enc-dec: the encoder's layers and its mixer
    num_encoder_layers: int = 0
    encoder_mixer: str = "attn"     # attn | flare  (seamless FLARE-encoder variant)
    # hybrid (zamba2)
    shared_attn_every: int = 0      # apply the shared attention block every k layers
    lora_rank: int = 0              # per-invocation LoRA rank on the shared block
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # the LMs' training: activation checkpointing per decoder layer, and the
    # per-device microbatch of a train step (the pde family ignores remat)
    remat: str = "full"             # full | dots | none
    microbatch: int = 1


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int                    # points (N) or tokens per example
    global_batch: int               # examples per step (B)
    step: str = "train"             # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
    "pde_40k": ShapeConfig("pde_40k", 40000, 8, "train"),
    "pde_1m": ShapeConfig("pde_1m", 1048576, 1, "train"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 1e-3
    warmup_frac: float = 0.1
    weight_decay: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
