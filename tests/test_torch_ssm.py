"""The port's RWKV-6 and Mamba2 mixers (``repro_torch/models/ssm.py``) against
the JAX package's (``repro/models/ssm.py``) on the same inputs and weights.

The inputs are drawn with numpy from a seed; a layer's weights are drawn by
the JAX package and carried in with ``interop``. The scans (RWKV-6's WKV in
its scan, factored and exact chunked forms, SSD's scan and chunked forms,
the causal conv with a right-padded bucket's ``lengths``) are held at atol
1e-4, as tests/test_ssm.py holds the JAX forms against each other; the
blocks against the JAX blocks (full sequence, chunked and scan, with and
without ``lengths``) at 1e-4 in fp32 (bf16 compute: 2e-2 of the largest
output), and stepped a token at a time against
their own full-sequence run at 2e-3 (tests/test_ssm.py's block tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JSSMConfig
from repro.models import ssm as jssm
from repro_torch.config import SSMConfig
from repro_torch.interop import load_jax_params
from repro_torch.models import ssm

ATOL = 1e-4
STEP_ATOL = 2e-3
GEN = lambda: torch.Generator().manual_seed(0)


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(got, want, atol=ATOL):
    """got: a port tensor; want: a JAX array or a port tensor."""
    if isinstance(want, torch.Tensor):
        want = want.detach().double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _wkv_inputs(b=2, t=32, h=3, d=8, seed=0, decay="trained"):
    r = _np(b, t, h, d, seed=seed, scale=0.5)
    k = _np(b, t, h, d, seed=seed + 1, scale=0.5)
    v = _np(b, t, h, d, seed=seed + 2)
    w = 1.0 / (1.0 + np.exp(-2.0 * _np(b, t, h, d, seed=seed + 3))) * 0.98 + 0.01
    if decay == "trained":   # the factored form's bounded-decay contract
        w = w * 0.24 + 0.75
    elif decay == "strong":
        w = np.full_like(w, 1e-6)
    u = _np(h, d, seed=seed + 4, scale=0.3)
    s0 = _np(b, h, d, d, seed=seed + 5, scale=0.1)
    return [r, k, v, w.astype(np.float32), u, s0]


# --- RWKV-6 WKV ----------------------------------------------------------------


def test_wkv_scan_matches_jax():
    jx, tx = _both(_wkv_inputs())
    y, s = ssm.rwkv6_wkv_scan(*tx)
    jy, js = jssm.rwkv6_wkv_scan(*jx)
    _close(y, jy)
    _close(s, js)
    y0, _ = ssm.rwkv6_wkv_scan(*tx[:5])      # no initial state
    _close(y0, jssm.rwkv6_wkv_scan(*jx[:5])[0])


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("intra", ["factored", "exact"])
def test_wkv_chunked_matches_jax_and_scan(intra, chunk):
    jx, tx = _both(_wkv_inputs(decay="trained" if intra == "factored" else "any"))
    y, s = ssm.rwkv6_wkv_chunked(*tx, chunk=chunk, intra=intra)
    jy, js = jssm.rwkv6_wkv_chunked(*jx, chunk=chunk, intra=intra)
    _close(y, jy)
    _close(s, js)
    ys, ss = ssm.rwkv6_wkv_scan(*tx)
    _close(y, ys)
    _close(s, ss)


def test_wkv_strong_decay():
    """Near-zero decays: the exact form matches the scan; the factored form,
    outside its contract here, stays finite (its exponent clipped at 40)."""
    jx, tx = _both(_wkv_inputs(decay="strong"))
    ys, _ = ssm.rwkv6_wkv_scan(*tx)
    ye, _ = ssm.rwkv6_wkv_chunked(*tx, chunk=8, intra="exact")
    _close(ye, ys)
    _close(ye, jssm.rwkv6_wkv_chunked(*jx, chunk=8, intra="exact")[0])
    yf, _ = ssm.rwkv6_wkv_chunked(*tx, chunk=8, intra="factored")
    assert bool(yf.isfinite().all())
    _close(yf, jssm.rwkv6_wkv_chunked(*jx, chunk=8, intra="factored")[0])


def test_wkv_chunked_rejects_ragged_length():
    _, tx = _both(_wkv_inputs(t=12))
    with pytest.raises(ValueError, match="not divisible"):
        ssm.rwkv6_wkv_chunked(*tx, chunk=8)
    with pytest.raises(ValueError, match="intra"):
        ssm.rwkv6_wkv_chunked(*_both(_wkv_inputs())[1], chunk=8, intra="dense")


# --- SSD -------------------------------------------------------------------------


def _ssd_inputs(b=2, t=32, h=3, p=8, n=16, seed=10):
    x = _np(b, t, h, p, seed=seed)
    dt = np.log1p(np.exp(_np(b, t, h, seed=seed + 1))).astype(np.float32)
    a_log = np.log(np.linspace(1, 8, h)).astype(np.float32)
    bm = _np(b, t, n, seed=seed + 2, scale=0.5)
    cm = _np(b, t, n, seed=seed + 3, scale=0.5)
    d = np.ones(h, np.float32)
    s0 = _np(b, h, p, n, seed=seed + 4, scale=0.1)
    return [x, dt, a_log, bm, cm, d, s0]


def test_ssd_scan_matches_jax():
    jx, tx = _both(_ssd_inputs())
    y, s = ssm.ssd_scan(*tx)
    jy, js = jssm.ssd_scan(*jx)
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_scan(chunk):
    jx, tx = _both(_ssd_inputs())
    y, s = ssm.ssd_chunked(*tx, chunk=chunk)
    jy, js = jssm.ssd_chunked(*jx, chunk=chunk)
    _close(y, jy)
    _close(s, js)
    ys, ss = ssm.ssd_scan(*tx)
    _close(y, ys)
    _close(s, ss)
    y0, _ = ssm.ssd_chunked(*tx[:6], chunk=chunk)   # no initial state
    _close(y0, jssm.ssd_chunked(*jx[:6], chunk=chunk)[0])


@pytest.mark.parametrize("lengths", [None, (12, 1), (0, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(lengths, with_state):
    """The conv and its carried state, at each row's last real token when a
    right-padded bucket gives ``lengths`` (a gather here, a dynamic_slice
    under vmap in JAX)."""
    x, w, b = _np(2, 16, 6, seed=20), _np(6, 4, seed=21, scale=0.1), _np(6, seed=22)
    st = _np(2, 6, 3, seed=23) if with_state else None
    arrs = [x, w, b] + ([st] if with_state else [])
    jx, tx = _both(arrs)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    y, s = ssm._causal_conv1d(*tx, lengths=tl)
    jy, js = jssm._causal_conv1d(*jx, lengths=jl)
    _close(y, jy)
    _close(s, js)


def test_softplus_is_exact_above_torch_threshold():
    """dt's softplus is log(1 + e^x) everywhere, as jax.nn.softplus."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.9, 20.5, 25.0, 90.0], np.float32)
    _close(ssm._softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), atol=0)


# --- blocks ------------------------------------------------------------------------


RWKV_CFG = dict(kind="rwkv6", head_dim=8, chunk=8)
MAMBA_CFG = dict(kind="mamba2", state_dim=8, head_dim=8, expand=2, chunk=8)


def _rwkv_layer(c=32, ff=64):
    jp = jssm.init_rwkv6_layer(jax.random.PRNGKey(3), c, JSSMConfig(**RWKV_CFG), ff)
    # non-zero ddlerp mixes and bonus, so every term reaches the output
    rng = np.random.default_rng(5)
    jp = dict(jp, **{name: jnp.asarray(rng.standard_normal(jp[name].shape).astype(np.float32)
                                       * 0.3) for name in ("mu_x", "mu", "cm_mu_k", "cm_mu_r")})
    tp = ssm.init_rwkv6_layer(c, SSMConfig(**RWKV_CFG), ff, generator=GEN())
    return jp, load_jax_params(tp, jax.tree.map(np.asarray, jp))


def _mamba_layer(c=16):
    jp = jssm.init_mamba2_layer(jax.random.PRNGKey(3), c, JSSMConfig(**MAMBA_CFG))
    rng = np.random.default_rng(6)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(jp["dt_bias"].shape) * 0.5,
                                      jnp.float32))
    tp = ssm.init_mamba2_layer(c, SSMConfig(**MAMBA_CFG), generator=GEN())
    return jp, load_jax_params(tp, jax.tree.map(np.asarray, jp))


def _lengths(lengths):
    if lengths is None:
        return None, None
    return jnp.asarray(lengths, jnp.int32), torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("impl,lengths", [("chunked", None), ("scan", None),
                                          ("chunked", (16, 11)), ("scan", (16, 5))])
def test_rwkv6_block_matches_jax(impl, lengths):
    jp, tp = _rwkv_layer()
    x = _np(2, 16, 32, seed=30, scale=0.5)
    jl, tl = _lengths(lengths)
    y, st = ssm.rwkv6_block(tp, torch.from_numpy(x), SSMConfig(**RWKV_CFG), impl=impl,
                            lengths=tl)
    jy, jst = jssm.rwkv6_block(jp, jnp.asarray(x), JSSMConfig(**RWKV_CFG), impl=impl,
                               lengths=jl)
    _close(y, jy)
    for a, b in zip(st, jst):
        _close(a, b)


def test_rwkv6_block_stepped_matches_full():
    jp, tp = _rwkv_layer()
    cfg = SSMConfig(**RWKV_CFG)
    x = torch.from_numpy(_np(2, 16, 32, seed=31, scale=0.5))
    y_full, st_full = ssm.rwkv6_block(tp, x, cfg, impl="chunked")
    state, outs = None, []
    for t in range(16):
        y_t, state = ssm.rwkv6_block(tp, x[:, t:t + 1], cfg, state=state, impl="scan")
        outs.append(y_t)
    _close(torch.cat(outs, 1), y_full, STEP_ATOL)
    for a, b in zip(state, st_full):
        _close(a, b, STEP_ATOL)


def test_rwkv6_block_bf16_matches_jax():
    """bf16 compute: the ddlerp in bf16, the decay and WKV in fp32."""
    jp, tp = _rwkv_layer()
    x = _np(2, 16, 32, seed=32, scale=0.5)
    y, st = ssm.rwkv6_block(tp, torch.from_numpy(x).bfloat16(), SSMConfig(**RWKV_CFG))
    jy, jst = jssm.rwkv6_block(jp, jnp.asarray(x, jnp.bfloat16), JSSMConfig(**RWKV_CFG))
    assert y.dtype == torch.bfloat16 and st.wkv.dtype == torch.float32
    # a bf16 output rounds at 2^-8 of its size: held over its largest value
    for got, want in ((y.float(), np.asarray(jy, np.float32)), (st.wkv, jst.wkv)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.detach().double().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("impl,lengths", [("chunked", None), ("scan", None),
                                          ("chunked", (16, 9)), ("scan", (3, 16))])
def test_mamba2_block_matches_jax(impl, lengths):
    jp, tp = _mamba_layer()
    x = _np(2, 16, 16, seed=40, scale=0.5)
    jl, tl = _lengths(lengths)
    y, st = ssm.mamba2_block(tp, torch.from_numpy(x), SSMConfig(**MAMBA_CFG), impl=impl,
                             lengths=tl)
    jy, jst = jssm.mamba2_block(jp, jnp.asarray(x), JSSMConfig(**MAMBA_CFG), impl=impl,
                                lengths=jl)
    _close(y, jy)
    _close(st.conv, jst.conv)
    _close(st.ssm, jst.ssm)


def test_mamba2_block_stepped_matches_full():
    """Token by token from a zero state (conv and SSD) against the chunked
    full sequence, and a prefill's state continued by steps against the
    full sequence's tail."""
    jp, tp = _mamba_layer()
    cfg = SSMConfig(**MAMBA_CFG)
    x = torch.from_numpy(_np(2, 16, 16, seed=41, scale=0.5))
    y_full, _ = ssm.mamba2_block(tp, x, cfg, impl="chunked")
    state = ssm.Mamba2State(torch.zeros(2, 2 * 16 + 2 * 8, 3), torch.zeros(2, 4, 8, 8))
    outs = []
    for t in range(16):
        y_t, state = ssm.mamba2_block(tp, x[:, t:t + 1], cfg, state=state, impl="scan")
        outs.append(y_t)
    _close(torch.cat(outs, 1), y_full, STEP_ATOL)
    _, st8 = ssm.mamba2_block(tp, x[:, :8], cfg, impl="chunked")
    outs = []
    for t in range(8, 16):
        y_t, st8 = ssm.mamba2_block(tp, x[:, t:t + 1], cfg, state=st8, impl="scan")
        outs.append(y_t)
    _close(torch.cat(outs, 1), y_full[:, 8:], STEP_ATOL)


def test_mamba2_state_dtypes():
    """The conv state in the compute dtype, the SSD state in fp32."""
    _, tp = _mamba_layer()
    y, st = ssm.mamba2_block(tp, torch.from_numpy(_np(1, 8, 16, seed=42)).bfloat16(),
                             SSMConfig(**MAMBA_CFG))
    assert (y.dtype, st.conv.dtype, st.ssm.dtype) == (torch.bfloat16, torch.bfloat16,
                                                       torch.float32)


def test_layer_leaves_match_the_jax_tree():
    """Every leaf of a JAX layer is a parameter of the port's, shape for
    shape (dense kernels transposed), and nothing more."""
    from repro_torch.interop import params_from_jax

    for jp, tp in (_rwkv_layer(), _mamba_layer()):
        want = params_from_jax(jax.tree.map(np.asarray, jp))
        got = tp.state_dict()
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape for k in got)


def test_smoke_configs_match_jax():
    from repro.configs import get_smoke_config as jsmoke, get_config as jget
    from repro_torch.configs import get_config, get_smoke_config

    for arch in ("rwkv6_3b", "zamba2_7b"):
        for port, ref in ((get_config(arch), jget(arch)), (get_smoke_config(arch), jsmoke(arch))):
            p, r = dataclasses.asdict(port), dataclasses.asdict(ref)
            assert {k: p[k] for k in p} == {k: r[k] for k in p}, arch
