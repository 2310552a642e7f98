"""The flash-attention path of the port against the JAX package's Pallas route.

On CPU tensors ``repro_torch.kernels.attention.flash_attention`` runs its
plain version, which these tests hold against the JAX ``flash_attention``
(the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it,
with its 32 x 32 tiles so that its tile skip is exercised). Inputs are drawn
with numpy from a seed; weights are carried from the JAX tree. Tolerances:
the kernel sweep at ``tests/test_kernels.py``'s (fp32 atol 2e-5 / rtol 1e-4,
bf16 2e-2); ``attn_sdpa`` 1e-5 in fp32 and 2e-2 in bf16
(``tests/test_torch_attention.py``); the smoke LMs' logits within 1e-5 of
max |logit| in fp32 compute and 2e-2 in bf16, as
``test_qwen2_smoke_lm_matches_jax``. The CUDA kernel is held against the
same plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels.ops import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.api import get_model as jget_model
from repro_torch.config import replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import load_jax_params, params_from_jax, unstack_layers
from repro_torch.kernels import attention as tkernel
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_model

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
MASKS = [(True, None), (False, None), (True, 24)]


def _tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=1e-4)


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (sq, skv, skv))


def _close(got, want, **tol):
    if isinstance(want, torch.Tensor):
        want = want.detach().float()
    np.testing.assert_allclose(np.asarray(got.detach().float(), np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("sq,skv,d", [(64, 64, 16), (128, 64, 8), (96, 96, 32)])
def test_flash_attention_matches_jax(sq, skv, d, causal, window, dtype):
    """tests/test_kernels.py's sweep: the port's ops.flash_attention (its
    plain version on the CPU, no launch) against the JAX one."""
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, 2, sq, skv, d, seed=sq + skv + d)
    kw = dict(scale=1.0 / np.sqrt(d), causal=causal, window=window)
    before = ops.launch_counts()
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), **kw)
    assert ops.launch_counts() == before
    want = jflash(*(jnp.asarray(x, jdt) for x in (q, k, v)), block_q=32, block_kv=32, **kw)
    assert got.dtype == tdt and got.shape == want.shape
    _close(got, want, **_tol(dtype))


def test_flash_attention_fully_masked_rows():
    """Rows that see no key return exact zeros, never NaN (Sq=128 over Skv=64
    with a window of 24: rows >= 87 are fully masked), as the JAX kernel
    does; and tests/test_kernels.py's window-1 case stays finite."""
    q, k, v = _qkv(1, 2, 128, 64, 8, seed=7)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3, causal=True,
                              window=24)
    want = jflash(*map(jnp.asarray, (q, k, v)), scale=0.3, causal=True, window=24,
                  block_q=32, block_kv=32)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, :, 87:] == 0).all()) and bool((got[:, :, :87].abs().sum(-1) > 0).all())
    _close(got, want, **_tol("float32"))
    q, k, v = _qkv(1, 1, 32, 32, 8, seed=8)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3, causal=True,
                              window=1)
    assert bool(torch.isfinite(got).all())
    _close(got, jflash(*map(jnp.asarray, (q, k, v)), scale=0.3, causal=True, window=1,
                       block_q=8, block_kv=8), **_tol("float32"))


def test_flash_attention_group_layout_and_offset():
    """The wrapper takes [G, S, D] as the TPU kernel does, and strided
    [B, H, S, D] views, with the same result; the plain version's q_offset
    runs a block of queries alone."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 3, 40, 40, 8, seed=9))
    full = tkernel.flash_attention(q, k, v, scale=0.5, causal=True, window=7)
    grouped = tkernel.flash_attention(q.reshape(6, 40, 8), k.reshape(6, 40, 8),
                                      v.reshape(6, 40, 8), scale=0.5, causal=True, window=7)
    torch.testing.assert_close(grouped.reshape(2, 3, 40, 8), full, rtol=0, atol=0)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    torch.testing.assert_close(tkernel.flash_attention(*strided, scale=0.5, causal=True,
                                                       window=7), full, rtol=1e-6, atol=1e-6)
    from repro_torch.kernels.ref import flash_attention_ref

    block = flash_attention_ref(q[:, :, 16:], k, v, scale=0.5, causal=True, window=7,
                                q_offset=16)
    torch.testing.assert_close(block, full[:, :, 16:], rtol=1e-6, atol=1e-6)


def test_flash_attention_rejects():
    """What neither the kernel nor its plain version takes raises, on the
    CPU too: shapes, dtypes, devices, a negative window, autograd; the ops
    wrapper wants [B, H, S, D]."""
    x = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="one shape"):
        tkernel.flash_attention(x, x[:, :, :4], x, scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        tkernel.flash_attention(x, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8), scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        tkernel.flash_attention(x, x.bfloat16(), x, scale=1.0)
    with pytest.raises(ValueError, match="several devices"):
        tkernel.flash_attention(x, x.to("meta"), x, scale=1.0)
    with pytest.raises(ValueError, match="window"):
        tkernel.flash_attention(x, x, x, scale=1.0, window=-1)
    with pytest.raises(RuntimeError, match="forward-only"):
        tkernel.flash_attention(x.requires_grad_(), x, x, scale=1.0)
    with pytest.raises(ValueError, match=r"\[B, H, Sq, D\]"):
        ops.flash_attention(x[0], x[0], x[0], scale=1.0)


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_flash_attention_gqa_reads_unexpanded_kv(hkv):
    """k and v of Hkv | H heads (query head h reads KV head h // (H / Hkv))
    give the call on K and V expanded to H heads, bit for bit, through the
    kernel wrapper (4-D and the flattened [G, S, D]) and ops.flash_attention,
    on CPU tensors (the plain version, no launch); H % Hkv != 0 raises."""
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((2, 4, 40, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, hkv, 33, 8)).astype(np.float32))
            for _ in range(2))
    kw = dict(scale=0.4, causal=True, window=7)
    before = ops.launch_counts()
    got = tkernel.flash_attention(q, k, v, **kw)
    want = tkernel.flash_attention(q, k.repeat_interleave(4 // hkv, 1),
                                   v.repeat_interleave(4 // hkv, 1), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw), want, rtol=0, atol=0)
    flat = tkernel.flash_attention(q.reshape(8, 40, 8), k.reshape(2 * hkv, 33, 8),
                                   v.reshape(2 * hkv, 33, 8), **kw)
    torch.testing.assert_close(flat.reshape(2, 4, 40, 8), want, rtol=0, atol=0)
    assert ops.launch_counts() == before
    three = torch.zeros(2, 3, 33, 8)   # 4 query heads over 3 KV heads
    with pytest.raises(ValueError, match="not a multiple"):
        tkernel.flash_attention(q, three, three, **kw)


def _route_operands(case: str):
    """q, k, v for :func:`tkernel.flash_route`: the model's [B, H, S, D] views
    of [B, S, H, D] (GQA k/v of 2 heads) at D 8 / 96 / 128, and the calls TMA
    cannot take: D=5, a row stride of 30 elements, a base 8 bytes off."""
    def views(d, dtype=torch.bfloat16, h=6, hkv=2):
        return (torch.zeros(2, 50, h, d, dtype=dtype).transpose(1, 2),
                *(torch.zeros(2, 50, hkv, d, dtype=dtype).transpose(1, 2) for _ in range(2)))

    if case.startswith("bf16 D="):
        return views(int(case.removeprefix("bf16 D=")))
    if case == "fp32 D=128":
        return views(128, torch.float32)
    if case == "bf16 row stride 30":
        wide = torch.zeros(2, 6, 50, 30, dtype=torch.bfloat16)
        return wide[..., :24], wide[:, :2, :, :24], wide[:, :2, :, :24]
    assert case == "bf16 base off by 8 bytes"
    flat = torch.zeros(2 * 6 * 50 * 24 + 4, dtype=torch.bfloat16)[4:]
    q = flat.view(2, 6, 50, 24)
    return q, q[:, :2], q[:, :2]


ROUTE_CASES = {"bf16 D=8": "tensor_core", "bf16 D=96": "tensor_core",
               "bf16 D=128": "tensor_core", "bf16 D=5": "bf16_mma",
               "bf16 row stride 30": "bf16_mma", "bf16 base off by 8 bytes": "bf16_mma",
               "fp32 D=128": "fp32"}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_flash_route(case):
    """flash_route picks the kernel from dtype, D and strides alone: the
    wgmma kernel for bf16 at D % 8 == 0 that TMA can address (16-byte base
    and strides), the mma.sync bf16 kernel for any other bf16 call, fp32's
    own route; other dtypes raise."""
    assert tkernel.flash_route(*_route_operands(case)) == ROUTE_CASES[case]
    with pytest.raises(ValueError, match="dtype"):
        tkernel.flash_route(*(t.half() for t in _route_operands("bf16 D=8")))


UNIT_CASES = {"bf16 D=5": 2, "bf16 row stride 30": 4, "bf16 base off by 8 bytes": 8,
              "bf16 D=100": 8, "bf16 D=128": 16, "fp32 D=128": 16, "fp32 D=5": 4}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_copy_unit(case):
    """The bytes a copy of the bf16_mma and fp32 kernels moves: the widest of
    16, 8 and 4 (bf16) or 16 (fp32) that divides a row, every stride and
    every base, else one element (a row stride of 60 bytes takes 4, a base 8
    bytes off takes 8, D=100 takes 8: 200-byte rows)."""
    if case == "fp32 D=5":
        ops = tuple(t.float() for t in _route_operands("bf16 D=5"))
    else:
        ops = _route_operands(case)
    assert tkernel.copy_unit(*ops) == UNIT_CASES[case]


def _jcfg(cfg):
    from repro.config import AttnConfig as JAttn

    return JAttn(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 5])
def test_gqa_forward_pallas_matches_jax(window, dtype, monkeypatch):
    """gqa_forward(impl='pallas') at the smoke qwen2's attention (6 query
    heads over 2 KV heads), which hands the flash kernel the KV heads
    unexpanded, against the JAX package's gqa_forward(impl='pallas')
    (expanded K/V, the Pallas kernel in interpret mode): y and the rope'd
    k, v, fp32 1e-5 and bf16 2e-2 of max |y|."""
    tdt, jdt = DTYPES[dtype]
    atol = 1e-5 if dtype == "float32" else 2e-2
    cfg = replace(get_smoke_config("qwen2_1_5b").attn, sliding_window=window)
    assert cfg.num_heads // cfg.num_kv_heads == 3
    jp = jattn.init_gqa(jax.random.PRNGKey(5), _jcfg(cfg), 24)
    tp = load_jax_params(tattn.init_gqa(cfg, 24, generator=torch.Generator().manual_seed(0)),
                         _np(jp))
    x = np.random.default_rng(23).standard_normal((2, 37, 24)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    expanded = []
    monkeypatch.setattr(tattn, "_expand_kv", lambda t, g: expanded.append(g) or t)
    with torch.no_grad():
        y, (k, v) = tattn.gqa_forward(tp, torch.from_numpy(x).to(tdt), cfg,
                                      positions=torch.from_numpy(pos.copy()), impl="pallas",
                                      return_kv=True)
    assert expanded == []
    jy, (jk, jv) = jattn.gqa_forward(jax.tree.map(lambda a: a.astype(jdt), jp),
                                     jnp.asarray(x, jdt), _jcfg(cfg), positions=jnp.asarray(pos),
                                     impl="pallas", return_kv=True)
    assert y.dtype == tdt and tuple(k.shape) == (2, cfg.num_kv_heads, 37, cfg.head_dim)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, atol=atol * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())),
               rtol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_attn_sdpa_pallas_matches_jax(causal, window, dtype):
    """attn_sdpa(impl='pallas') against the JAX package's on ragged lengths,
    and against the port's own 'xla' route."""
    tdt, jdt = DTYPES[dtype]
    atol = 1e-5 if dtype == "float32" else 2e-2
    q, k, v = _qkv(2, 3, 37, 41, 8, seed=11)
    kw = dict(scale=8 ** -0.5, causal=causal, window=window)
    ts = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    got = tattn.attn_sdpa(*ts, impl="pallas", **kw)
    want = jattn.attn_sdpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), impl="pallas", **kw)
    assert got.dtype == tdt and got.shape == want.shape
    _close(got, want, atol=atol, rtol=atol)
    _close(got, tattn.attn_sdpa(*ts, impl="xla", **kw), atol=atol, rtol=atol)


def test_attn_sdpa_pallas_rejects_q_offset():
    """The flash kernel takes no q_offset: the port raises where the JAX
    package's pallas route drops it silently."""
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="q_offset"):
        tattn.attn_sdpa(x, x, x, scale=1.0, impl="pallas", q_offset=3)
    assert tattn.attn_sdpa(x, x, x, scale=1.0, impl="pallas", q_offset=0).shape == x.shape


@pytest.mark.parametrize("smoke", [False, True])
def test_phi3_config_matches_jax(smoke):
    tc = (get_smoke_config if smoke else get_config)("phi3_mini_3_8b")
    jc = (jget_smoke if smoke else jget_config)("phi3_mini_3_8b")
    for f in dataclasses.fields(tc):
        tv, jv = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(tv):
            for g in dataclasses.fields(tv):
                assert getattr(tv, g.name) == getattr(jv, g.name), (f.name, g.name)
        else:
            assert tv == jv, f.name
    assert (tc.attn.q_dim, tc.attn.kv_dim) == (jc.attn.q_dim, jc.attn.kv_dim)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype)
    tcfg = replace(get_smoke_config(arch), compute_dtype=dtype)
    jm, tm = jget_model(jcfg), get_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    net = load_jax_params(tm.init(0), unstack_layers(_np(jp)))
    return jcfg, jp, tcfg, tm, net


def test_interop_carries_phi3_tree():
    """The phi3 tree: an untied lm_head over the padded vocab (32,256 at full
    size), no QKV biases, MHA projections."""
    jcfg, jp, tcfg, tm, net = _lm("phi3_mini_3_8b")
    sd = params_from_jax(unstack_layers(_np(jp)))
    assert set(sd) == set(net.state_dict())
    assert "lm_head.weight" in sd and not any(key.endswith("wq.bias") for key in sd)
    assert tuple(net.lm_head.weight.shape) == (ttransformer.padded_vocab(tcfg.vocab),
                                               tcfg.d_model)
    assert ttransformer.padded_vocab(get_config("phi3_mini_3_8b").vocab) == 32256
    np.testing.assert_array_equal(net.lm_head.weight.detach().numpy(),
                                  np.asarray(jp["lm_head"]["kernel"]).T)
    np.testing.assert_array_equal(net.layers[1].attn.wv.weight.detach().numpy(),
                                  np.asarray(jp["layers"]["attn"]["wv"]["kernel"][1]).T)


ARCHS = ["qwen2_1_5b", "phi3_mini_3_8b"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_pallas_matches_jax(arch, dtype):
    """lm_forward and lm_prefill (right-padded lengths) under impl='pallas'
    against the JAX package's, over max |logit|; both prefills' KV caches
    agree too."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    jcfg, jp, tcfg, tm, net = _lm(arch, dtype)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tcfg.vocab, (2, 11)).astype(np.int32)
    lengths = np.asarray([11, 7], np.int32)

    def held(got, want):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= tol, err

    jl, _ = jtransformer.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, impl="pallas")
    with torch.no_grad():
        tl, _ = ttransformer.lm_forward(net, torch.from_numpy(toks).long(), tcfg, impl="pallas")
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    held(tl[..., : tcfg.vocab], jl[..., : jcfg.vocab])
    batch = {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)}
    jlog, jc = jtransformer.lm_prefill(jp, batch, jcfg, 16, impl="pallas")
    with torch.no_grad():
        tlog, tc = ttransformer.lm_prefill(net, {"tokens": torch.from_numpy(toks).long(),
                                                 "lengths": torch.from_numpy(lengths)},
                                           tcfg, 16, impl="pallas")
    held(tlog, jlog)
    assert tc.pos.tolist() == lengths.tolist()
    for cache, (jk, jv) in zip(tc.layers, zip(jc.layers.k, jc.layers.v)):
        for got, want in ((cache.k, jk), (cache.v, jv)):
            scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
            _close(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_pallas_prefill_matches_xla(arch):
    """4 greedy decode steps in fp32 from the caches of a pallas prefill and
    of an xla prefill (right-padded lengths): the same tokens, logits within
    1e-5 of max |logit|."""
    _, _, tcfg, tm, net = _lm(arch)
    rng = np.random.default_rng(17)
    batch = {"tokens": torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 9))).long(),
             "lengths": torch.tensor([9, 5])}
    runs = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            logits, caches = ttransformer.lm_prefill(net, batch, tcfg, 16, impl=impl)
            outs = [logits]
            for _ in range(4):
                logits, caches = tm.decode_step(net, outs[-1].argmax(-1)[:, None], caches)
                outs.append(logits)
            runs[impl] = torch.stack(outs, 1)
    got, want = runs["pallas"], runs["xla"]
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
