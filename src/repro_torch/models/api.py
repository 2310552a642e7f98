"""Model API of the port: ``get_model(cfg)`` -> init / forward / loss / plans,
and for the LMs prefill / decode_step / init_caches / prefill_into.

Counterpart of ``repro/models/api.py`` for the PDE family, ``flare_lm``,
the gqa and MLA decoders (``dense``, e.g. qwen2, minicpm3), the MLA + MoE
decoder (``moe``, deepseek-v2-lite), RWKV-6 (``ssm``, rwkv6-3b), the
Mamba2 + shared-attention hybrid (``hybrid``, zamba2-7b) and the
encoder-decoder (``encdec`` / ``audio``, seamless-m4t-large-v2):

    m = get_model(cfg, device="cuda")   # plans resolved here, once, for the device
    net = m.init(seed)                  # the model's modules on that device (the LMs:
                                        # m.init(seed, generator=g) draws from g,
                                        # e.g. a card's generator for 15.7B weights)
    pred = m.forward(net, batch)        # inference under m.plans["infer"]
    loss = m.loss(net, batch)           # differentiable, under m.plans["train"]
                                        # (PDE: surrogate_loss; the LMs: batch
                                        # {"tokens", "labels"}; encdec: also "embeds")
    # the LMs (flare_lm, dense, moe, ssm, hybrid) and encdec (prefill and
    # decode_step only; encdec's batch: {"embeds", "tokens"}, no "lengths"):
    logits, caches = m.prefill(net, batch, capacity)      # batch may carry "lengths"
    logits, caches = m.decode_step(net, token, caches)    # token [B, 1]
    caches = m.init_caches(batch_size, capacity)          # device="meta" allocates nothing
    # continuous-batching insertion prefill: prefill a request batch and
    # write its caches into live pool slots (in place)
    logits, pool = m.prefill_into(net, batch, pool, slots, capacity=capacity)
    # the prefix cache's suffix prefill (gqa and mla only): continue caches
    # holding batch["offsets"] prompt tokens by batch["tokens"]
    logits, caches = m.prefill_suffix(net, batch, caches)

The train plan is always resolved with ``requires_grad=True``, so training
never lands on a forward-only kernel. PDE under a mesh
(``get_model(cfg, mesh=mesh)``): both plans are resolved with it, so only
sharded backends serve (``packed_shard`` through the kernels, or the plain
``seqparallel``); every rank runs the model on its slice of each example's
tokens (``distributed.sharding.shard_tokens``), and ``loss`` sums the relative L2's
squares over the token ranks. The mesh's ``"model"`` axis must be 1: the
port's model keeps its heads whole. PDE: on the card both plans resolve
to ``packed`` (the fused forward kernel, and under ``loss`` its fused
backward kernel through autograd); on the CPU to the plain ``sdpa``. A
policy that can only serve inference (``pallas``) still builds, and
``loss`` raises its resolve error. flare_lm: the plans are resolved on the
causal path; the infer plan is ``causal_pallas`` (the causal kernel, whose
tile is its own) on the card and the plain ``causal_stream`` on the CPU, the
train plan ``causal_stream``, whose ``chunk_size`` is the config's
``flare_chunk``; a forward-only policy (``causal_pallas`` alone) builds, and
``loss`` raises as the PDE family's does.
dense and moe (gqa or mla attention): no mixer plan (attention has its own
``impl``, "auto" here: the ``chunked`` route beyond 2,048 tokens, ``xla``
below). ``prefill_suffix`` is set where the cache is position-addressable
history (gqa or mla, unwindowed) and ``None`` otherwise (``flare_lm``, the
PDE family), as in the JAX package; the serving engine's prefix cache is off
where it is ``None``. ``forward`` returns ``(logits [B, S, vocab] fp32,
aux)``, aux the MoE layers' load-balancing loss; the LMs' ``loss`` is
``transformer.lm_loss``, each decoder layer checkpointed as ``cfg.remat``
says.
ssm and hybrid: no mixer plan and no ``prefill_suffix`` (a recurrent state
is a running summary that no range of shared blocks can rebuild, so the
prefix cache stays off), as in the JAX package; ``loss`` is the plain
cross-entropy of ``rwkv_lm.rwkv_loss`` / ``zamba.zamba_loss``, and
``prefill`` / ``decode_step`` run ``rwkv_prefill`` / ``rwkv_decode_step``
or ``zamba_prefill`` / ``zamba_decode_step`` (the hybrid's attention on
"auto"; the dense pool, a paged pool's gather route or its kernel route,
the paged-attention kernel, at decode).
encdec and audio (``transformer.encdec_*``): a mixer plan only for the
FLARE encoder (``encoder_mixer="flare"``), resolved on the set-mixer path
in the compute dtype (bf16 by default; ``packed`` on the card, ``sdpa`` on
the CPU) with ``flare_heads or num_heads`` heads and ``flare_latents or
256`` latents; the attention encoder has none. ``forward`` takes
``{"embeds", "tokens"}`` and returns ``(logits [B, T, vocab] fp32, 0)``;
``loss`` also reads ``"labels"``; ``prefill`` encodes and teacher-forces
the target prefix, ``decode_step`` advances it (``EncDecCaches``: the
caches need the memory, so ``init_caches``, ``prefill_into`` and
``prefill_suffix`` are None and the serving engine does not take the
family), as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.config import ModelConfig

# nominal token count for plan resolution when no hint is given (plan
# validity never depends on it)
DEFAULT_TOKENS_HINT = 4096


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss: Callable[..., torch.Tensor]
    # resolved mixer plans: {"infer": ...[, "train": ...]}
    plans: Mapping[str, Any] = field(default_factory=dict)
    # the mesh whose token axes the model's plans split over, or None
    mesh: Any = None
    # serving entry points (the LMs); None for the PDE family
    prefill: Optional[Callable[..., Any]] = None
    decode_step: Optional[Callable[..., Any]] = None
    init_caches: Optional[Callable[..., Any]] = None
    prefill_into: Optional[Callable[..., Any]] = None
    # (net, batch, caches) -> (logits, caches): the prefix cache's hit path
    prefill_suffix: Optional[Callable[..., Any]] = None


def make_prefill_into(prefill, init_caches):
    """Generic insertion prefill: run the family prefill on the request
    batch (right-padded bucket + "lengths"), then write the per-request
    cache lanes into the pool at ``slots``, in place (``serve.cache``'s
    slot-axis discovery keeps this family-agnostic). Paged pools use
    ``serve.pool.PagedModelCache.make_prefill_into`` instead."""

    def prefill_into(net, batch, pool, slots, *, capacity):
        from repro_torch.serve.cache import insert_slots, slot_axes

        logits, part = prefill(net, batch, capacity)
        return logits, insert_slots(pool, part, slots, slot_axes(init_caches, capacity))

    return prefill_into


def _resolve_plans(cfg: ModelConfig, policy, device: torch.device,
                   seq_len_hint: Optional[int], mesh=None):
    from repro_torch.core.dispatch import MixerPlan, MixerShape
    from repro_torch.core.policy import resolve_policy

    encdec = cfg.family in ("encdec", "audio")
    if cfg.family in ("dense", "moe", "ssm", "hybrid") or (encdec and
                                                           cfg.encoder_mixer != "flare"):
        return {}, None   # no FLARE mixer: no plan
    causal = cfg.family == "flare_lm"
    if causal:
        heads, latents = cfg.attn.num_heads, cfg.attn.flare_latents
        dtype = getattr(torch, cfg.compute_dtype)
    elif encdec:   # the FLARE encoder computes in compute_dtype, as the decoder does
        heads, latents = cfg.flare_heads or cfg.attn.num_heads, cfg.flare_latents or 256
        dtype = getattr(torch, cfg.compute_dtype)
    else:   # the PDE family computes in fp32 whatever compute_dtype says
        heads, latents, dtype = cfg.flare_heads, cfg.flare_latents, torch.float32
    shape = MixerShape(batch=1, heads=heads, tokens=seq_len_hint or DEFAULT_TOKENS_HINT,
                       latents=latents, head_dim=cfg.d_model // heads)
    kind = device.type
    plans = {"infer": resolve_policy(policy, shape, dtype, device=kind, causal=causal,
                                     mesh=mesh)}
    try:
        plans["train"] = resolve_policy(policy, shape, dtype, device=kind, requires_grad=True,
                                        causal=causal, mesh=mesh)
        train_error = None
    except ValueError as e:
        # kept without its traceback: its frames reach the caller's (a model
        # being built beside its weights), which would live until a gc pass
        train_error = e.with_traceback(None)
    if causal:
        # the config's chunk drives the plain causal scan; the kernel's tile is its own
        plans = {key: MixerPlan(p.backend, {**p.params, "chunk_size": cfg.attn.flare_chunk})
                 if p.backend == "causal_stream" else p for key, p in plans.items()}
    return plans, train_error


def _train_guard(loss_fn, train_error):
    """``loss_fn``, or, for a model built with an inference-only policy, a
    function that raises the recorded resolve error the moment training is
    attempted (never a silent fallback onto another backend)."""
    if train_error is None:
        return loss_fn

    def refuse(net, batch):
        raise ValueError("this model was built with an inference-only mixer policy "
                         f"and cannot train: {train_error}")

    return refuse


def get_model(cfg: ModelConfig, *, policy=None, device=None,
              seq_len_hint: Optional[int] = None, mesh=None) -> Model:
    """``policy``: a MixerPolicy, a MixerPlan, or None (the ambient policy),
    resolved here once for ``device`` (default ``"cuda"``) and, for the PDE
    family, ``mesh`` (a DeviceMesh whose token axes split each example)."""
    if cfg.family not in ("pde", "flare_lm", "dense", "moe", "ssm", "hybrid", "encdec", "audio"):
        raise ValueError(f"family {cfg.family!r} is not ported; the port has 'pde', "
                         "'flare_lm', 'dense', 'moe', 'ssm', 'hybrid', 'encdec' and 'audio'")
    if cfg.family in ("dense", "moe") and cfg.attn.kind not in ("gqa", "mla"):
        raise ValueError(f"the port's {cfg.family} family has gqa or mla attention, not "
                         f"{cfg.attn.kind!r}")
    group = None
    if mesh is not None:
        from repro_torch.distributed.compat import axis_group, axis_size
        from repro_torch.distributed.sharding import fsdp_axes

        if cfg.family != "pde":
            raise ValueError(f"the port runs {cfg.family} on one device; meshes serve the "
                             "pde family")
        if "model" in mesh.mesh_dim_names and axis_size(mesh, "model") > 1:
            raise ValueError("the port's model keeps its heads whole: the mesh's 'model' axis "
                             f"must be 1, not {axis_size(mesh, 'model')}")
        group = axis_group(mesh, fsdp_axes(mesh))
    dev = torch.device("cuda" if device is None else device)
    plans, train_error = _resolve_plans(cfg, policy, dev, seq_len_hint, mesh)
    if cfg.family in ("flare_lm", "dense", "moe"):
        return _lm(cfg, dev, plans, train_error)
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent(cfg, dev)
    if cfg.family in ("encdec", "audio"):
        return _encdec(cfg, dev, plans, train_error)
    from repro_torch.models import pde

    def init(seed: int) -> pde.Surrogate:
        gen = torch.Generator().manual_seed(seed)
        return pde.init_surrogate("flare", in_dim=3, out_dim=1, dim=cfg.d_model,
                                  num_blocks=cfg.num_layers, num_heads=cfg.flare_heads,
                                  num_latents=cfg.flare_latents, generator=gen, device=dev)

    def forward(net: pde.Surrogate, batch) -> torch.Tensor:
        with torch.no_grad():
            return pde.surrogate_forward(net, batch["x"], num_heads=cfg.flare_heads,
                                         policy=plans["infer"])

    def loss(net: pde.Surrogate, batch) -> torch.Tensor:
        return pde.surrogate_loss(net, batch, num_heads=cfg.flare_heads,
                                  policy=plans["train"], group=group)

    return Model(cfg=cfg, init=init, forward=forward, loss=_train_guard(loss, train_error),
                 plans=plans, mesh=mesh)


def _lm(cfg: ModelConfig, dev: torch.device, plans, train_error) -> Model:
    from repro_torch.models import transformer as t

    infer, train = plans.get("infer"), plans.get("train")

    def init(seed: int, *, generator: Optional[torch.Generator] = None) -> t.LM:
        """The weights from ``generator`` when given (its seed is the
        caller's), else from a CPU generator seeded with ``seed``."""
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        return t.init_lm(cfg, generator=gen, device=dev)

    def forward(net: t.LM, batch) -> tuple:
        with torch.no_grad():
            logits, aux = t.lm_forward(net, batch["tokens"], cfg, plan=infer)
        return logits[..., : cfg.vocab], aux

    def prefill(net: t.LM, batch, capacity: int) -> tuple:
        with torch.no_grad():
            return t.lm_prefill(net, batch, cfg, capacity)

    def decode_step(net: t.LM, token: torch.Tensor, caches) -> tuple:
        with torch.no_grad():
            return t.lm_decode_step(net, token, caches, cfg)

    def init_caches(batch: int, capacity: int, device=None):
        return t.init_lm_caches(batch, cfg, capacity, device=dev if device is None else device)

    def loss(net: t.LM, batch) -> torch.Tensor:
        return t.lm_loss(net, batch, cfg, plan=train)

    def prefill_suffix(net: t.LM, batch, caches) -> tuple:
        with torch.no_grad():
            return t.lm_prefill_suffix(net, batch, caches, cfg)

    return Model(cfg=cfg, init=init, forward=forward, loss=_train_guard(loss, train_error),
                 plans=plans, prefill=prefill, decode_step=decode_step, init_caches=init_caches,
                 prefill_into=make_prefill_into(prefill, init_caches),
                 prefill_suffix=(prefill_suffix if cfg.attn.kind in ("gqa", "mla")
                                 and cfg.attn.sliding_window is None else None))


def _recurrent(cfg: ModelConfig, dev: torch.device) -> Model:
    """The ssm (RWKV-6) and hybrid (Zamba2) families' entry points."""
    if cfg.family == "ssm":
        from repro_torch.models import rwkv_lm as r

        make, fwd, lossf = r.init_rwkv_lm, r.rwkv_forward, r.rwkv_loss
        pre, dec = r.rwkv_prefill, r.rwkv_decode_step
        caches = lambda bs, cap, device: r.init_rwkv_caches(bs, cfg, cap, device=device)
    else:
        from repro_torch.models import zamba as z

        make, fwd, lossf = z.init_zamba, z.zamba_forward, z.zamba_loss
        pre, dec = z.zamba_prefill, z.zamba_decode_step
        caches = lambda bs, cap, device: z.init_zamba_caches(bs, cfg, cap, device=device)

    def init(seed: int, *, generator: Optional[torch.Generator] = None):
        """The weights from ``generator`` when given, else from a CPU
        generator seeded with ``seed``."""
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        return make(cfg, generator=gen, device=dev)

    def forward(net, batch) -> tuple:
        with torch.no_grad():
            logits, aux = fwd(net, batch["tokens"], cfg)
        return logits[..., : cfg.vocab], aux

    def prefill(net, batch, capacity: int) -> tuple:
        with torch.no_grad():
            return pre(net, batch, cfg, capacity)

    def decode_step(net, token: torch.Tensor, c) -> tuple:
        with torch.no_grad():
            return dec(net, token, c, cfg)

    def init_caches(batch: int, capacity: int, device=None):
        return caches(batch, capacity, dev if device is None else device)

    return Model(cfg=cfg, init=init, forward=forward, loss=lambda net, b: lossf(net, b, cfg),
                 prefill=prefill, decode_step=decode_step, init_caches=init_caches,
                 prefill_into=make_prefill_into(prefill, init_caches))


def _encdec(cfg: ModelConfig, dev: torch.device, plans, train_error) -> Model:
    """The encoder-decoder's entry points: no slot-pool caches (the caches
    come from prefill, which needs the memory)."""
    from repro_torch.models import transformer as t

    infer, train = plans.get("infer"), plans.get("train")

    def init(seed: int, *, generator: Optional[torch.Generator] = None) -> t.EncDec:
        """The weights from ``generator`` when given, else from a CPU
        generator seeded with ``seed``."""
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        return t.init_encdec(cfg, generator=gen, device=dev)

    def forward(net: t.EncDec, batch) -> tuple:
        with torch.no_grad():
            logits, aux = t.encdec_forward(net, batch, cfg, plan=infer)
        return logits[..., : cfg.vocab], aux

    def prefill(net: t.EncDec, batch, capacity: int) -> tuple:
        with torch.no_grad():
            return t.encdec_prefill(net, batch, cfg, capacity, plan=infer)

    def decode_step(net: t.EncDec, token: torch.Tensor, caches) -> tuple:
        with torch.no_grad():
            return t.encdec_decode_step(net, token, caches, cfg)

    def loss(net: t.EncDec, batch) -> torch.Tensor:
        return t.encdec_loss(net, batch, cfg, plan=train)

    return Model(cfg=cfg, init=init, forward=forward, loss=_train_guard(loss, train_error),
                 plans=plans, prefill=prefill, decode_step=decode_step)
