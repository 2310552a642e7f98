"""The port's MoE FFN (``models/moe.py``) against the JAX package's.

Inputs are drawn with numpy from a seed and given to both packages; the
weights are carried from the JAX tree (the stacked experts as they are).
``moe_ffn``'s output (over max |JAX|) and aux loss within 1e-5 in fp32,
with the Mixtral and the DeepSeek routing branch, one group and several
(``group_size``), a capacity that drops assignments, and the shared
experts; in bf16 within 2e-2 with the router's logits forced to tie, where
the expert indices must equal JAX's (``jax.lax.top_k`` puts the lower index
first; ``torch.topk`` promises no order)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch.config import MoEConfig
from repro_torch.interop import load_jax_params
from repro_torch.models import moe as tmoe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
C = 24


def _moe(cfg: MoEConfig, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), JMoE(**dataclasses.asdict(cfg)), C)
    tp = tmoe.init_moe(cfg, C, generator=torch.Generator().manual_seed(0))
    return jp, load_jax_params(tp, jax.tree.map(np.asarray, jp))


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run(cfg, jp, tp, x, dtype, **kw):
    tdt, jdt = DTYPES[dtype]
    with torch.no_grad():
        y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x).to(tdt), cfg, **kw)
    jp_c = jax.tree.map(lambda a: a.astype(jdt), jp)
    run = jax.jit(functools.partial(jmoe.moe_ffn, cfg=JMoE(**dataclasses.asdict(cfg)), **kw))
    jy, jaux = run(jp_c, jnp.asarray(x, jdt))
    return y, aux, jy, jaux


def _dropped(tp, x, cfg, gs) -> int:
    """Routed assignments past their expert's capacity, in the port's groups."""
    xt = torch.from_numpy(x)
    t = xt.shape[0] * xt.shape[1]
    g = t if t % min(gs, t) else min(gs, t)
    cap = max(1, int(g * cfg.capacity_factor * cfg.top_k / cfg.num_experts))
    _, idx = tmoe._router_probs(tmoe.dense(tp.router, xt.reshape(t // g, g, -1)), cfg)
    counts = torch.nn.functional.one_hot(idx, cfg.num_experts).sum(dim=(1, 2))   # [groups, E]
    return int((counts - cap).clamp_min(0).sum())


CASES = {
    # name: (config, tokens [B, S], group size)
    "mixtral_one_group": (MoEConfig(num_experts=8, top_k=2, expert_ffn=16,
                                    norm_topk_prob=False), (2, 9), 1024),
    "deepseek_shared_groups": (MoEConfig(num_experts=6, top_k=3, num_shared=2, expert_ffn=12,
                                         shared_ffn=20, norm_topk_prob=True, routed_scale=1.5),
                               (2, 8), 4),
    "capacity_drops": (MoEConfig(num_experts=4, top_k=2, expert_ffn=16, capacity_factor=0.5,
                                 norm_topk_prob=False), (3, 10), 1024),
    "decode_slots": (MoEConfig(num_experts=16, top_k=6, num_shared=1, expert_ffn=8,
                               shared_ffn=16, norm_topk_prob=False), (8, 1), 1024),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax_fp32(case):
    cfg, (b, s), gs = CASES[case]
    jp, tp = _moe(cfg, seed=len(case))
    x = np.random.default_rng(len(case)).standard_normal((b, s, C)).astype(np.float32)
    y, aux, jy, jaux = _run(cfg, jp, tp, x, "float32", group_size=gs)
    assert y.shape == jy.shape and y.dtype == torch.float32
    assert _rel(y, jy) <= TOL["float32"]
    assert abs(aux.item() - float(jaux)) <= TOL["float32"] * abs(float(jaux))
    if case in ("capacity_drops", "decode_slots"):
        with torch.no_grad():
            assert _dropped(tp, x, cfg, gs) > 0


def test_capacity_priority_matches_jax():
    """Which assignments keep their expert slot: earlier tokens and
    higher-ranked slots first (a cumulative sum over the flattened
    [group * k] axis), identical to JAX's on a forced pile-up onto expert 0."""
    cfg = MoEConfig(num_experts=4, top_k=2, expert_ffn=8, capacity_factor=0.5,
                    norm_topk_prob=False)
    jp, tp = _moe(cfg, seed=3)
    # a zero router: every logit ties, so every token picks experts 0 and 1
    with torch.no_grad():
        tp.router.weight.zero_()
    jp = {**jp, "router": {"kernel": jnp.zeros_like(jp["router"]["kernel"])}}
    x = np.random.default_rng(3).standard_normal((1, 8, C)).astype(np.float32)
    y, _, jy, _ = _run(cfg, jp, tp, x, "float32")
    assert _rel(y, jy) <= TOL["float32"]
    # all logits tie at 0: experts 0 and 1 in index order, capacity 2 each,
    # so tokens 0 and 1 are served and the rest fall through
    gate, idx = tmoe._router_probs(torch.zeros(1, 8, 4), cfg)
    assert idx[0, :, 0].tolist() == [0] * 8 and idx[0, :, 1].tolist() == [1] * 8
    assert y[0, 2:].abs().max().item() == 0.0 and y[0, :2].abs().max().item() > 0


@pytest.mark.parametrize("norm_topk", [False, True])
def test_router_tie_order_matches_jax_bf16(norm_topk):
    """bf16 router logits forced to tie (duplicated kernel columns): the
    expert indices equal JAX's lower-index-first order, the gates and the
    output within bf16's tolerance."""
    cfg = MoEConfig(num_experts=8, top_k=3, num_shared=1, expert_ffn=16, shared_ffn=16,
                    norm_topk_prob=norm_topk)
    jp, tp = _moe(cfg, seed=5)
    kern = np.asarray(jp["router"]["kernel"]).copy()
    kern[:, 4] = kern[:, 1]   # experts 1 and 4 tie, and 2, 5, 7 tie
    kern[:, 5] = kern[:, 2]
    kern[:, 7] = kern[:, 2]
    jp = {**jp, "router": {"kernel": jnp.asarray(kern)}}
    with torch.no_grad():
        tp.router.weight.copy_(torch.from_numpy(kern.T))
    x = np.random.default_rng(5).standard_normal((2, 7, C)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    logits = tmoe.dense(tp.router, xt)
    assert torch.equal(logits[..., 1], logits[..., 4]) and torch.equal(logits[..., 2], logits[..., 7])
    jlogits = jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(kern, jnp.bfloat16)
    jgate, jidx = jmoe._router_probs(jlogits, JMoE(**dataclasses.asdict(cfg)))
    gate, idx = tmoe._router_probs(torch.from_numpy(np.asarray(jlogits, np.float32)).bfloat16(),
                                   cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _rel(gate, jgate) <= 1e-6
    y, aux, jy, jaux = _run(cfg, jp, tp, x, "bfloat16")
    assert y.dtype == torch.bfloat16 and _rel(y, jy) <= TOL["bfloat16"]
    assert abs(aux.item() - float(jaux)) <= TOL["bfloat16"] * abs(float(jaux))


def test_top_k_is_stable_descending():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    val, idx = tmoe.top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 5]] and val.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    jval, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("dtype", list(TOL))
def test_shared_experts_match_jax(dtype):
    """The shared SwiGLU alone: the routed experts' weights zeroed in both
    packages leave y = shared(x)."""
    cfg = MoEConfig(num_experts=4, top_k=2, num_shared=2, expert_ffn=8, shared_ffn=0)
    jp, tp = _moe(cfg, seed=7)
    assert tp.shared.w_gate.weight.shape == (2 * 8, C)   # shared_ffn 0: expert_ffn * num_shared
    jp = {**jp, "w_down": jnp.zeros_like(jp["w_down"])}
    with torch.no_grad():
        tp.w_down.zero_()
    x = np.random.default_rng(7).standard_normal((2, 5, C)).astype(np.float32)
    y, _, jy, _ = _run(cfg, jp, tp, x, dtype)
    assert _rel(y, jy) <= TOL[dtype]
    with torch.no_grad():
        want = tmoe.swiglu(tp.shared, torch.from_numpy(x).to(DTYPES[dtype][0]))
    assert torch.equal(y, want)


def test_init_moe_layout():
    """The stacked experts' shapes and truncated-normal scales, the JAX
    tree's leaves (``router``, ``w_gate``/``w_up`` [E, C, F], ``w_down``
    [E, F, C], ``shared``)."""
    cfg = MoEConfig(num_experts=6, top_k=2, num_shared=1, expert_ffn=64, shared_ffn=32)
    tp = tmoe.init_moe(cfg, 128, generator=torch.Generator().manual_seed(1))
    assert tp.w_gate.shape == tp.w_up.shape == (6, 128, 64) and tp.w_down.shape == (6, 64, 128)
    assert isinstance(tp.w_gate, torch.nn.Parameter) and tp.router.weight.shape == (6, 128)
    assert abs(tp.w_up.std().item() * 128 ** 0.5 - 0.88) < 0.02   # truncated at 2 sigma
    assert tp.w_down.abs().max().item() <= 2 / 64 ** 0.5 + 1e-6
    jp = jmoe.init_moe(jax.random.PRNGKey(0), JMoE(**dataclasses.asdict(cfg)), 128)
    assert {k: np.shape(v) for k, v in jp.items() if k.startswith("w_")} == {
        k: tuple(getattr(tp, k).shape) for k in ("w_gate", "w_up", "w_down")}
    assert set(dict(tp.named_children())) == {"router", "shared"} == set(jp) - {
        "w_gate", "w_up", "w_down"}
