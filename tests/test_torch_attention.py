"""The port's gqa attention and the qwen2 decoder against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages; weights
are carried from the JAX tree (``interop.unstack_layers``). Tolerances:
rope and attention 1e-5 in fp32 and 2e-2 in bf16 (tests/test_kernels.py);
the smoke qwen2's logits (forward, prefill with right-padded lengths, 8
decode steps) within 1e-5 of max |logit| in fp32 compute (two layers of
fp32 GEMMs in another order; they sit near 5e-7), and 2e-2 in bf16."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import rope as jrope
from repro.models.api import get_model as jget_model
from repro_torch.config import AttnConfig, replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import load_jax_params, params_from_jax, unstack_layers
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope
from repro_torch.models.api import get_model

TOL = {"float32": (torch.float32, jnp.float32, 1e-5),
       "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
WINDOWED = AttnConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=8, qkv_bias=True,
                      sliding_window=5)
PLAIN = AttnConfig(kind="gqa", num_heads=6, num_kv_heads=2, head_dim=8, qkv_bias=True,
                   rope_theta=1e6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach().float(), np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=atol)


def _jcfg(cfg: AttnConfig):
    from repro.config import AttnConfig as JAttn

    return JAttn(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("smoke", [False, True])
def test_qwen2_config_matches_jax(smoke):
    tc = (get_smoke_config if smoke else get_config)("qwen2_1_5b")
    jc = (jget_smoke if smoke else jget_config)("qwen2_1_5b")
    for f in dataclasses.fields(tc):
        tv, jv = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(tv):
            for g in dataclasses.fields(tv):
                assert getattr(tv, g.name) == getattr(jv, g.name), (f.name, g.name)
        else:
            assert tv == jv, f.name
    assert (tc.attn.q_dim, tc.attn.kv_dim) == (jc.attn.q_dim, jc.attn.kv_dim)


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(trope.rope_frequencies(16, theta), jrope.rope_frequencies(16, theta), 1e-7)
        ang_t = trope.rope_angles(torch.from_numpy(pos), 16, theta)
        ang_j = jrope.rope_angles(jnp.asarray(pos), 16, theta)
        np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), rtol=1e-6)
        for shape in ((2, 7, 16), (2, 3, 7, 16)):   # [B, S, D] and [B, H, S, D]
            x = rng.standard_normal(shape).astype(np.float32)
            _close(trope.apply_rope(torch.from_numpy(x), ang_t),
                   jrope.apply_rope(jnp.asarray(x), ang_j), 1e-5)
    mpos = rng.integers(0, 64, (3, 2, 7)).astype(np.int32)
    _close(trope.mrope_angles(torch.from_numpy(mpos), 16, 1e4, (2, 3, 3)),
           jrope.mrope_angles(jnp.asarray(mpos), 16, 1e4, (2, 3, 3)), 1e-4)
    np.testing.assert_array_equal(trope.text_positions(2, 5, offset=3).numpy(),
                                  np.asarray(jrope.text_positions(2, 5, offset=3)))
    np.testing.assert_array_equal(trope.text_mrope_positions(2, 5).numpy(),
                                  np.asarray(jrope.text_mrope_positions(2, 5)))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("impl,causal,window,q_offset", [
    ("xla", True, None, 0), ("xla", False, None, 0), ("xla", True, 5, 0), ("xla", True, None, 4),
    ("chunked", True, None, 0), ("chunked", True, 7, 0), ("chunked", False, None, 0)])
def test_attn_sdpa_matches_jax(dtype, impl, causal, window, q_offset):
    tdt, jdt, atol = TOL[dtype]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, n, 8)).astype(np.float32) for n in (37, 41, 41))
    kw = dict(scale=8 ** -0.5, causal=causal, window=window, q_offset=q_offset, impl=impl,
              chunk=16)
    got = tattn.attn_sdpa(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), **kw)
    want = jattn.attn_sdpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    _close(got, want, atol)


def _gqa(cfg: AttnConfig, d_model: int, seed: int = 0):
    jp = jattn.init_gqa(jax.random.PRNGKey(seed), _jcfg(cfg), d_model)
    tp = tattn.init_gqa(cfg, d_model, generator=torch.Generator().manual_seed(0))
    return jp, load_jax_params(tp, _np(jp))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("cfg", [PLAIN, WINDOWED], ids=["plain", "windowed"])
def test_gqa_forward_matches_jax(cfg, dtype):
    tdt, jdt, atol = TOL[dtype]
    jp, tp = _gqa(cfg, 24)
    x = np.random.default_rng(2).standard_normal((2, 11, 24)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    with torch.no_grad():
        y, (k, v) = tattn.gqa_forward(tp, torch.from_numpy(x).to(tdt), cfg,
                                      positions=torch.from_numpy(pos.copy()), return_kv=True)
    jp_c = jax.tree.map(lambda a: a.astype(jdt), jp)
    jy, (jk, jv) = jattn.gqa_forward(jp_c, jnp.asarray(x, jdt), _jcfg(cfg),
                                     positions=jnp.asarray(pos), return_kv=True)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, atol * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())))


@pytest.mark.parametrize("cfg", [PLAIN, WINDOWED], ids=["plain", "windowed"])
def test_prefill_kv_cache_and_gqa_decode_match_jax(cfg):
    """Prefill K/V packed into a cache with right-padded lengths (capacity
    above and below the bucket, and a window's ring buffer), then decode
    steps against it: the outputs and the cache rows each step, fp32."""
    jp, tp = _gqa(cfg, 24, seed=3)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    lengths = np.asarray([9, 6], np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    with torch.no_grad():
        _, (k, v) = tattn.gqa_forward(tp, torch.from_numpy(x), cfg,
                                      positions=torch.from_numpy(pos.copy()), return_kv=True)
    _, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                    return_kv=True)
    for capacity in (16, 8):
        cache = tattn.prefill_kv_cache(k, v, cfg, capacity, torch.from_numpy(lengths))
        jcache = jattn.prefill_kv_cache(jk, jv, jcfg, capacity, jnp.asarray(lengths))
        for got, want in zip(cache, jcache):
            _close(got, want, 1e-5)
    for step in range(4):
        xt = rng.standard_normal((2, 1, 24)).astype(np.float32)
        pt = (lengths + step)[:, None]
        with torch.no_grad():
            y, cache = tattn.gqa_decode(tp, torch.from_numpy(xt), cfg, cache,
                                        positions=torch.from_numpy(pt))
        jy, jcache = jattn.gqa_decode(jp, jnp.asarray(xt), jcfg, jcache, positions=jnp.asarray(pt))
        _close(y, jy, 1e-5)
        for got, want in zip(cache, jcache):
            _close(got, want, 1e-5)
    valid = tattn.decode_valid_mask(torch.tensor([3, 20]), 8)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jattn.decode_valid_mask(
        jnp.asarray([3, 20]), 8)))


def _qwen2(dtype: str = "float32"):
    jcfg = dataclasses.replace(jget_smoke("qwen2_1_5b"), compute_dtype=dtype)
    tcfg = replace(get_smoke_config("qwen2_1_5b"), compute_dtype=dtype)
    jm, tm = jget_model(jcfg), get_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    net = load_jax_params(tm.init(0), unstack_layers(_np(jp)))
    return jm, jp, tm, net


def test_interop_carries_qwen2_tree():
    """The stacked layers, the wq/wk/wv biases and the tied embedding table
    land in the port's state_dict; there is no lm_head."""
    jm, jp, tm, net = _qwen2()
    sd = params_from_jax(unstack_layers(_np(jp)))
    assert set(sd) == set(net.state_dict())
    assert "layers.1.attn.wk.bias" in sd and "lm_head.weight" not in sd
    np.testing.assert_array_equal(net.embed.table.detach().numpy(), np.asarray(jp["embed"]["table"]))
    np.testing.assert_array_equal(net.layers[1].attn.wq.weight.detach().numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"]["kernel"][1]).T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_smoke_lm_matches_jax(dtype):
    """forward, prefill with right-padded lengths, and 8 greedy decode steps
    (the JAX package's tokens fed to both) over max |logit|."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    jm, jp, tm, net = _qwen2(dtype)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, (2, 11)).astype(np.int32)
    lengths = np.asarray([11, 7], np.int32)

    def held(got, want):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= tol, err

    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(net, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    held(tl, jl)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)}, 32)
    tlog, tc = tm.prefill(net, {"tokens": torch.from_numpy(toks).long(),
                                "lengths": torch.from_numpy(lengths)}, 32)
    held(tlog, jlog)
    assert tc.pos.tolist() == lengths.tolist()
    for _ in range(8):
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        jlog, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(net, torch.from_numpy(tok).long(), tc)
        held(tlog, jlog)
    assert tc.pos.tolist() == (lengths + 8).tolist()
    assert math.isclose(float(jnp.abs(jlog).max()), float(tlog.abs().max()), rel_tol=tol)


def test_dense_family_builds_on_cuda_without_a_card():
    """get_model defaults to cuda and resolves no mixer plan for gqa; its
    loss trains (here the smoke config's, on the CPU: a finite scalar)."""
    m = get_model(get_config("qwen2_1_5b"))
    assert m.plans == {} and m.prefill_into is not None
    sm = get_model(get_smoke_config("qwen2_1_5b"), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 9)))
    loss = sm.loss(sm.init(0), {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert loss.dim() == 0 and loss.requires_grad and math.isfinite(loss.item())
