"""The port's MLA attention and the MLA models against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages; weights
are carried from the JAX tree (``interop.unstack_layers``). Tolerances over
max |JAX|: 1e-5 in fp32 (attention, the absorbed decode, the extend, the
paged read's plain version at MLA's full-size shapes against the JAX
``paged_attention`` in Pallas interpret mode) and 2e-2 in bf16. The smoke
``deepseek_v2_lite_16b`` (MLA + MoE, one leading dense layer) and
``minicpm3_4b`` (MLA with q-LoRA): ``lm_forward``'s logits and aux,
``lm_loss``, ``lm_prefill`` with right-padded lengths and 8 greedy decode
steps. Serving: token-axis discovery, the dense pool against the paged
pool's gather and kernel routes (greedy tokens equal, every page returned),
and MiniCPM3's prefix cache on against off in bf16 (greedy tokens equal;
the MoE model is left out of that check: its capacity drops depend on which
tokens share a batch, as in the JAX package's tests)."""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels.paged_attention import paged_attention as jpaged_attention
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.api import get_model as jget_model
from repro_torch.config import AttnConfig, MLAConfig, replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import (from_jax_flat, load_jax_params, params_from_jax, to_jax_flat,
                                 unstack_layers)
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pool import PagedModelCache
from repro_torch.serve.pool.views import PagedLeaf, PagedTokenView
from repro_torch.serve.pool.quant import get_quant

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ARCHS = ("deepseek_v2_lite_16b", "minicpm3_4b")
_MODELS = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    """max |got - want| over max |want|; got a torch tensor, want an array."""
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mla_cfg(q_lora):
    return AttnConfig(kind="mla", num_heads=4, num_kv_heads=4, head_dim=16,
                      mla=MLAConfig(kv_lora_rank=24, q_lora_rank=q_lora, qk_nope_head_dim=16,
                                    qk_rope_head_dim=8, v_head_dim=16))


def _jcfg(cfg: AttnConfig):
    from repro.config import AttnConfig as JAttn
    from repro.config import MLAConfig as JMLA

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["mla"] = JMLA(**dataclasses.asdict(cfg.mla))
    return JAttn(**kw)


def _jit(fn, **static):
    """``fn`` compiled once with the keywords ``static`` bound (op by op, JAX
    compiles every op of a new shape)."""
    return jax.jit(functools.partial(fn, **static))


def _mla(q_lora, seed=0, d_model=40):
    cfg = _mla_cfg(q_lora)
    jp = jax.jit(jattn.init_mla, static_argnums=(1, 2))(jax.random.PRNGKey(seed), _jcfg(cfg),
                                                         d_model)
    tp = tattn.init_mla(cfg, d_model, generator=torch.Generator().manual_seed(0))
    return cfg, jp, load_jax_params(tp, _np(jp))


def _model(arch, dtype="float32"):
    key = (arch, dtype)
    if key not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke(arch), compute_dtype=dtype))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = get_model(replace(get_smoke_config(arch), compute_dtype=dtype), device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(_np(jp)))
        _MODELS[key] = (jm, jp, tm, net)
    return _MODELS[key]


def _fields_equal(t, j, where):
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _fields_equal(tv, jv, f"{where}.{f.name}")
        else:
            assert tv == jv, f"{where}.{f.name}"


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch, smoke):
    """Every field, the nested MLAConfig and MoEConfig included."""
    t = (get_smoke_config if smoke else get_config)(arch)
    j = (jget_smoke if smoke else jget_config)(arch)
    _fields_equal(t, j, arch)
    assert (t.moe is None) == (arch == "minicpm3_4b")


# --- MLA ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("q_lora", [None, 20], ids=["full_rank_q", "q_lora"])
def test_mla_forward_matches_jax(q_lora, dtype):
    """y and the returned latents / rotary key, both q branches, xla and
    chunked routes."""
    tdt, jdt = DTYPES[dtype]
    cfg, jp, tp = _mla(q_lora)
    x = np.random.default_rng(1).standard_normal((2, 11, 40)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    jp_c = jax.tree.map(lambda a: a.astype(jdt), jp)
    for impl in ("xla", "chunked"):
        with torch.no_grad():
            y, (c, kr) = tattn.mla_forward(tp, torch.from_numpy(x).to(tdt), cfg,
                                           positions=torch.from_numpy(pos), impl=impl,
                                           return_kv=True)
        jy, (jc, jkr) = _jit(jattn.mla_forward, cfg=_jcfg(cfg), impl=impl, return_kv=True)(
            jp_c, jnp.asarray(x, jdt), positions=jnp.asarray(pos))
        assert y.dtype == tdt and y.shape == jy.shape
        for got, want in ((y, jy), (c, jc), (kr, jkr)):
            assert _rel(got, want) <= TOL[dtype], impl


def _paged_view(leaf: torch.Tensor, block: int) -> PagedTokenView:
    """A [B, cap, D] cache leaf as a kernel-route view: each lane's pages
    laid out in order behind a trash row, the write target at ``length``."""
    b, cap, d = leaf.shape
    p = cap // block
    data = torch.cat([leaf.reshape(b * p, block, d), torch.zeros(1, block, d, dtype=leaf.dtype)])
    pt = torch.arange(b * p, dtype=torch.int32).reshape(b, p)
    meta = PagedLeaf(slot_axis=0, token_axis=1, view=cap, dtype=leaf.dtype)
    return PagedTokenView(data, None, pt, None, None, meta, block, get_quant("none"))


def _at(view: PagedTokenView, length: torch.Tensor) -> PagedTokenView:
    pos = length.long()
    view.page = view.pt.long().gather(1, (pos // view.block)[:, None])[:, 0]
    view.off = pos % view.block
    return view


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("q_lora", [None, 20], ids=["full_rank_q", "q_lora"])
def test_mla_absorbed_decode_matches_forward(q_lora, route):
    """Prefill 10 tokens, then 2 absorbed decode steps (a dense fp32 cache,
    or its pages through the kernel route's PagedTokenView and the paged
    read's plain version) against the full forward's rows, fp32."""
    cfg, _, tp = _mla(q_lora, seed=2)
    b, s = 2, 10
    x = torch.from_numpy(0.5 * np.random.default_rng(3).standard_normal((b, s + 2, 40))
                         .astype(np.float32))
    pos = torch.arange(s + 2, dtype=torch.int32).expand(b, s + 2)
    with torch.no_grad():
        full = tattn.mla_forward(tp, x, cfg, positions=pos, impl="xla")
        _, (c, kr) = tattn.mla_forward(tp, x[:, :s], cfg, positions=pos[:, :s], return_kv=True)
    # an fp32 cache (prefill_mla_cache's is bf16): the decode's own arithmetic at 1e-5
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 6))
    cache = tattn.MLACache(pad(c), pad(kr), torch.full((b,), s, dtype=torch.int32))
    if route == "kernel":
        cache = tattn.MLACache(_paged_view(cache.c_kv, 4), _paged_view(cache.k_rope, 4),
                               cache.length)
    scale = full.abs().max().item()
    for t in range(s, s + 2):
        if route == "kernel":
            cache = tattn.MLACache(_at(cache.c_kv, cache.length), _at(cache.k_rope, cache.length),
                                   cache.length)
        with torch.no_grad():
            y, cache = tattn.mla_decode(tp, x[:, t:t + 1], cfg, cache, positions=pos[:, t:t + 1])
        assert (y[:, 0] - full[:, t]).abs().max().item() <= 1e-5 * scale
    assert isinstance(cache.c_kv, PagedTokenView) == (route == "kernel")
    assert cache.length.tolist() == [s + 2] * b


@pytest.mark.parametrize("q_lora", [None, 20], ids=["full_rank_q", "q_lora"])
def test_prefill_mla_cache_and_decode_match_jax(q_lora):
    """Latents packed with right-padded lengths (capacity above and below
    the bucket), then 4 decode steps from the bf16 cache: outputs and cache
    rows each step, fp32 compute."""
    cfg, jp, tp = _mla(q_lora, seed=4)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    lengths = np.asarray([9, 6], np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    with torch.no_grad():
        _, (c, kr) = tattn.mla_forward(tp, torch.from_numpy(x), cfg,
                                       positions=torch.from_numpy(pos), return_kv=True)
    _, (jc, jkr) = _jit(jattn.mla_forward, cfg=jcfg, return_kv=True)(
        jp, jnp.asarray(x), positions=jnp.asarray(pos))
    for capacity in (16, 8):
        cache = tattn.prefill_mla_cache(c, kr, capacity, torch.from_numpy(lengths))
        jcache = jattn.prefill_mla_cache(jc, jkr, capacity, jnp.asarray(lengths))
        for got, want in zip(cache, jcache):
            assert got.shape == want.shape and _rel(got, want) <= 1e-5
    for step in range(4):
        xt = rng.standard_normal((2, 1, 40)).astype(np.float32)
        pt = (lengths + step)[:, None]
        with torch.no_grad():
            y, cache = tattn.mla_decode(tp, torch.from_numpy(xt), cfg, cache,
                                        positions=torch.from_numpy(pt))
        jy, jcache = _jit(jattn.mla_decode, cfg=jcfg)(jp, jnp.asarray(xt), cache=jcache,
                                                      positions=jnp.asarray(pt))
        assert _rel(y, jy) <= 1e-5
        for got, want in zip(cache, jcache):
            assert _rel(got.float(), want) <= 1e-5


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_extend_matches_jax(dtype):
    """A prefix of 7 and 4 tokens continued by 5 and 3 suffix tokens of a
    width-5 bucket: y and the latent rows."""
    tdt, jdt = DTYPES[dtype]
    cfg, jp, tp = _mla(20, seed=6)
    rng = np.random.default_rng(7)
    offsets, lens = np.array([7, 4], np.int32), np.array([5, 3], np.int32)
    cache = tattn.init_mla_cache(2, cfg, 16)
    c0 = rng.standard_normal((2, 16, 24)).astype(np.float32)
    k0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
    cache = tattn.MLACache(torch.from_numpy(c0).bfloat16(), torch.from_numpy(k0).bfloat16(),
                           torch.from_numpy(offsets))
    jcache = jattn.MLACache(jnp.asarray(c0, jnp.bfloat16), jnp.asarray(k0, jnp.bfloat16),
                            jnp.asarray(offsets))
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    pos = offsets[:, None] + np.arange(5, dtype=np.int32)[None, :]
    kw = dict(offsets=offsets, lengths=lens)
    with torch.no_grad():
        y, out = tattn.mla_extend(tp, torch.from_numpy(x).to(tdt), cfg, cache,
                                  positions=torch.from_numpy(pos),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    jp_c = jax.tree.map(lambda a: a.astype(jdt), jp)
    jy, jout = _jit(jattn.mla_extend, cfg=_jcfg(cfg))(jp_c, jnp.asarray(x, jdt), cache=jcache,
                                positions=jnp.asarray(pos),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    assert _rel(y, jy) <= TOL[dtype]
    assert _rel(out.c_kv.float(), jout.c_kv) <= TOL[dtype]
    assert out.length.tolist() == np.asarray(jout.length).tolist() == [12, 7]


@pytest.mark.parametrize("g,d,d2", [(16, 512, 64), (40, 256, 32)], ids=["deepseek", "minicpm3"])
def test_paged_attention_ref_mla_shapes_match_jax(g, d, d2):
    """The paged read at MLA's full-size shapes (one page head, G query heads,
    the latents both K and V, q2 over the rotary key, bf16 pages, fp32
    queries, a shuffled page table, lanes of 0 and a partial page) against
    the JAX ``paged_attention`` in interpret mode."""
    rng = np.random.default_rng(g)
    b, block, p = 3, 16, 5
    nb = b * p + 1
    lengths = np.array([0, 37, 80], np.int32)
    pt = rng.permutation(nb - 1)[: b * p].reshape(b, p).astype(np.int32)
    q = (rng.standard_normal((b, 1, g, d)) * d ** -0.5).astype(np.float32)
    q2 = (rng.standard_normal((b, 1, g, d2)) * 0.25).astype(np.float32)
    c = rng.standard_normal((nb, block, 1, d)).astype(np.float32)
    kr = rng.standard_normal((nb, block, 1, d2)).astype(np.float32)
    scale = 0.7
    tc, tkr = torch.from_numpy(c).bfloat16(), torch.from_numpy(kr).bfloat16()
    got = paged_attention_ref(torch.from_numpy(q), tc, tc, torch.from_numpy(pt),
                              torch.from_numpy(lengths), scale=scale, q2=torch.from_numpy(q2),
                              k2_pages=tkr, out_dtype=torch.float32)
    jc, jkr = jnp.asarray(c, jnp.bfloat16), jnp.asarray(kr, jnp.bfloat16)
    want = jpaged_attention(jnp.asarray(q), jc, jc, jnp.asarray(pt), jnp.asarray(lengths),
                            scale=scale, q2=jnp.asarray(q2), k2_pages=jkr,
                            out_dtype=jnp.float32, interpret=True)
    assert got.shape == want.shape and not got[0].any()
    assert _rel(got, want) <= 1e-5


# --- the smoke models ---------------------------------------------------------


def test_interop_carries_moe_tree():
    """dense_layers and the MoE's stacked experts land in the port's
    state_dict; to_jax_flat gives back the JAX tree's stacked leaves, and
    from_jax_flat restores them."""
    jm, jp, tm, net = _model("deepseek_v2_lite_16b")
    sd = params_from_jax(unstack_layers(_np(jp)))
    assert set(sd) == set(net.state_dict())
    assert len(net.dense_layers) == 1 and len(net.layers) == 2
    assert "dense_layers.0.mlp.w_gate.weight" in sd and "layers.1.mlp.w_gate" in sd
    assert "layers.0.mlp.shared.w_down.weight" in sd and "layers.0.attn.w_q.weight" in sd
    np.testing.assert_array_equal(net.layers[1].mlp.w_up.detach().numpy(),
                                  np.asarray(jp["layers"]["mlp"]["w_up"][1]))
    flat = to_jax_flat(net.state_dict())
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert set(flat) == set(jflat)
    for key, arr in jflat.items():
        np.testing.assert_array_equal(flat[key], arr, err_msg=key)
    back = from_jax_flat(flat)
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_matches_jax(arch, dtype):
    """lm_forward's logits and aux, lm_loss, lm_prefill with right-padded
    lengths and 8 greedy decode steps (the JAX package's tokens fed to
    both), each over max |JAX|. The bf16 MoE model is held against the JAX
    functions run op by op (``jax.disable_jit``): compiled, its layer scan
    fuses the bf16 elementwise ops and rounds elsewhere, which flips routing
    near ties (on these inputs the compiled and the op-by-op JAX forwards
    differ by 10% of max |logit|, while the port is within 2e-2 of the
    latter)."""
    tol = TOL[dtype]
    jm, jp, tm, net = _model(arch, dtype)
    if dtype == "bfloat16" and tm.cfg.moe is not None:
        with jax.disable_jit():
            _smoke_lm_held(jm, jp, tm, net, tol, lambda f, **kw: f)
    else:
        _smoke_lm_held(jm, jp, tm, net, tol, jax.jit)


def _smoke_lm_held(jm, jp, tm, net, tol, jit):
    """``jit``: how the JAX entry points run (each compiled once, or op by op)."""
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 128, (2, 11)).astype(np.int32)
    lengths = np.asarray([11, 7], np.int32)
    jl, jaux = jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(net, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == jl.shape and _rel(tl, jl) <= tol
    assert abs(taux.item() - float(jaux)) <= tol * max(1.0, abs(float(jaux)))
    assert (float(jaux) > 0) == (tm.cfg.moe is not None)
    # the forward's shapes (op by op, each new shape compiles its ops anew)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss = jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = tm.loss(net, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert abs(tloss.item() - float(jloss)) <= tol * abs(float(jloss))
    jlog, jc = jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)}, 32)
    tlog, tc = tm.prefill(net, {"tokens": torch.from_numpy(toks).long(),
                                "lengths": torch.from_numpy(lengths)}, 32)
    assert _rel(tlog, jlog) <= tol
    assert len(tc.dense) == len(net.dense_layers) and tc.pos.tolist() == lengths.tolist()
    decode = jit(jm.decode_step)
    for _ in range(8):
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        jlog, jc = decode(jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(net, torch.from_numpy(tok).long(), tc)
        assert _rel(tlog, jlog) <= tol
    assert tc.pos.tolist() == (lengths + 8).tolist()
    assert _rel(tc.layers[-1].c_kv.float(), jc.layers.c_kv[-1]) <= tol


@pytest.mark.parametrize("dtype", list(TOL))
def test_lm_prefill_suffix_matches_jax(dtype):
    """MiniCPM3's prefix from JAX's prefill, continued by 3 and 6 suffix
    tokens in both packages: the logits and the latent caches."""
    jm, jp, tm, net = _model("minicpm3_4b", dtype)
    rng = np.random.default_rng(9)
    full = rng.integers(1, 128, (2, 46)).astype(np.int32)
    offsets, lens = np.array([40, 40], np.int32), np.array([3, 6], np.int32)
    _, jcaches = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(full[:, :40]), "lengths": jnp.asarray(offsets)}, 64)
    sfx = np.zeros((2, 8), np.int32)
    for i in range(2):
        sfx[i, :lens[i]] = full[i, 40:40 + lens[i]]
    jbatch = {"tokens": jnp.asarray(sfx), "lengths": jnp.asarray(lens),
              "offsets": jnp.asarray(offsets)}
    jlogits, jout = _jit(jtransformer.lm_prefill_suffix, cfg=jm.cfg)(jp, jbatch, jcaches)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    layers = [tattn.MLACache(bf(jcaches.layers.c_kv[i]), bf(jcaches.layers.k_rope[i]),
                             torch.from_numpy(np.array(jcaches.layers.length[i])))
              for i in range(tm.cfg.num_layers)]
    tbatch = {"tokens": torch.from_numpy(sfx).long(), "lengths": torch.from_numpy(lens),
              "offsets": torch.from_numpy(offsets)}
    tlogits, tout = tm.prefill_suffix(net, tbatch,
                                      transformer.LMCaches([], layers, torch.from_numpy(offsets)))
    assert _rel(tlogits, jlogits) <= TOL[dtype]
    assert _rel(tout.layers[-1].c_kv.float(), jout.layers.c_kv[-1]) <= TOL[dtype]
    assert tout.pos.tolist() == np.asarray(jout.pos).tolist() == [43, 46]


def test_api_gates_and_serving_entry_points():
    """get_model takes the moe family and mla under dense and moe; the
    prefix cache's suffix prefill is set for both MLA models, as in JAX."""
    for arch in ARCHS:
        m = get_model(get_config(arch))
        assert m.plans == {} and m.prefill_into is not None and m.prefill_suffix is not None
        jm = jget_model(jget_config(arch))
        assert (m.prefill_suffix is None) == (jm.prefill_suffix is None)
    with pytest.raises(ValueError, match="gqa or mla"):
        get_model(replace(get_smoke_config("minicpm3_4b"),
                          attn=AttnConfig(kind="flare_stream", num_heads=4)))


# --- serving --------------------------------------------------------------------


@pytest.mark.parametrize("arch,paged_per_layer", [("deepseek_v2_lite_16b", 2),
                                                  ("minicpm3_4b", 2)])
def test_token_axis_discovery(arch, paged_per_layer):
    """MLA pages its latents and rotary key (JAX's stacked layers give 2
    paged leaves; the port keeps one leaf a layer, the dense layers' too),
    token axis 1 of [B, cap, D]; the lengths and positions stay dense. The
    kernel reads the latent pages with a singleton head axis."""
    _, _, tm, _ = _model(arch)
    pc = PagedModelCache(tm.init_caches, 32, pool_tokens=32, block=8)
    cfg = tm.cfg
    assert len(pc.spec.paged) == paged_per_layer * cfg.num_layers
    assert all((m.slot_axis, m.token_axis, m.view) == (0, 1, 32) for m in pc.spec.paged)
    pool = pc.init(2)
    m = cfg.attn.mla
    assert pool["data"][0].shape == (5, 8, m.kv_lora_rank)
    assert pool["data"][1].shape == (5, 8, m.qk_rope_head_dim)
    view = PagedTokenView(pool["data"][0], pool["scale"][0], None, None, None, pc.spec.paged[0],
                          8, pc.quant)
    assert view.pages()[0].shape == (5, 8, 1, m.kv_lora_rank)
    from repro.serve.pool import PagedModelCache as JPaged

    # the JAX package's stacks: layers (and dense_layers), each with 2 paged leaves
    stacks = 1 + (cfg.moe is not None and cfg.moe.first_dense_layers > 0)
    jm = jget_model(jget_smoke(arch))
    assert len(JPaged(jm.init_caches, 32, pool_tokens=32, block=8).spec.paged) == 2 * stacks


def _requests(vocab, n=5, seed=0, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    max_new = rng.integers(3, 11, n)
    return [(rng.integers(0, vocab, lens[i]).astype(np.int32), int(max_new[i]))
            for i in range(n)]


def _serve(engine, reqs):
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    return [o.tolist() for o in engine.run_all()]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_routes_token_identical(arch):
    """The dense pool, the paged pool's gather route and its kernel route
    (the paged read's plain version on the CPU): the same greedy tokens in
    fp32 compute, across admissions and block-boundary crossings; every page
    returned."""
    _, _, tm, net = _model(arch)
    reqs = _requests(tm.cfg.vocab)
    geo = dict(capacity=32, slots=2)
    paged = dict(pool_tokens=96, block_size=8)
    engines = {"dense": ServeEngine(tm, net, **geo),
               "gather": ServeEngine(tm, net, **geo, **paged, decode_backend="gather"),
               "kernel": ServeEngine(tm, net, **geo, **paged, decode_backend="paged")}
    outs = {name: _serve(eng, reqs) for name, eng in engines.items()}
    assert outs["gather"] == outs["dense"] and outs["kernel"] == outs["dense"]
    assert engines["kernel"].stats["decode_backend"] == "paged(block=8;quant=none)"
    for name in ("gather", "kernel"):
        eng = engines[name]
        eng.check_invariants()
        st = eng.stats["pool"]
        assert st["pages_appended"] > 0
        assert st["blocks_free"] == st["blocks_total"] and st["blocks_reserved"] == 0


def test_minicpm3_prefix_cache_on_off_equal_bf16():
    """Greedy tokens equal with the prefix cache on and off in bf16 (the
    kernel route over shared pages, a suffix prefill through mla_extend),
    the on-run hitting."""
    _, _, tm, net = _model("minicpm3_4b", "bfloat16")
    t = ((np.arange(1, 41, dtype=np.int32) * 7) % 49 + 1).astype(np.int32)
    prompts = [np.concatenate([t, np.array(tail, np.int32)]) for tail in ([7], [9], [9, 3, 22])]
    kw = dict(capacity=64, slots=1, pool_tokens=192, block_size=8)

    def run(prefix):
        eng = ServeEngine(tm, net, prefix_cache=prefix, **kw)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_all()
        eng.check_invariants()
        outs = {r.rid: list(r.tokens) for r in eng.sched.finished}
        return eng, [outs[r] for r in rids]

    on, outs_on = run(True)
    off, outs_off = run(False)
    assert outs_on == outs_off
    assert on.stats["prefix_cache"] and on.stats["prefix_hit_rate"] > 0
    assert off.stats["prefix_hit_rate"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_mla_smoke_on_cpu(arch):
    """``--arch`` takes both MLA configs: the smoke model through the paged
    pool's kernel route with the prefix cache on a shared-prefix workload."""
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4", "--pool-tokens", "192",
         "--block-size", "8", "--capacity", "64", "--prompt-len", "24", "--prefix-cache",
         "--share-prefix", "2", "--pin-prompt"],
        capture_output=True, text=True, cwd=repo, timeout=300,
        env={"PYTHONPATH": str(repo / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "decode backend: paged(block=8;quant=none)" in out.stdout
    assert "pinned 6 template blocks" in out.stdout and "5 requests / 14 tokens" in out.stdout
    assert "prefix cache: enabled=True" in out.stdout and "18 free after the run" in out.stdout
