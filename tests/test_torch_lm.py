"""The port's causal FLARE LM (``flare_lm``) against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages; weights
are carried from the JAX tree (``interop.unstack_layers``). Tolerances:
- rmsnorm, swiglu, embedding: 1e-6 (fp32, one op of difference);
- the ``flare_stream`` functions: 1e-5 (``tests/test_flare_stream.py``);
- the causal kernel's plain version against the Pallas kernel in interpret
  mode: 2e-5 in fp32, 3e-2 in bf16 (``tests/test_kernel_flare_causal.py``);
- the smoke model's logits (forward, prefill, decode): 1e-4 in fp32 compute
  (two layers of fp32 GEMMs in another order; they sit near 1e-6), and in
  bf16 compute 2e-2 of max |logit|, two bf16 ulps at the logits' magnitude.
Plan resolution for ``device="cuda"`` is a capability lookup and needs no
card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core import flare_stream as jfs
from repro.data.synthetic import TokenStream as JTokenStream
from repro.kernels.ops import flare_causal_fused as jflare_causal_fused
from repro.models.api import get_model as jget_model
from repro.nn import modules as jm
from repro_torch.config import SHAPES, replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import flare_stream as tfs
from repro_torch.core.dispatch import MixerShape, resolve
from repro_torch.core.policy import MixerPolicy, resolve_policy
from repro_torch.data.synthetic import TokenStream
from repro_torch.interop import load_jax_params, unstack_layers
from repro_torch.kernels.ops import flare_causal_fused, launch_counts
from repro_torch.models.api import get_model
from repro_torch.nn import modules as tm

LM_SHAPE = MixerShape(batch=1, heads=16, tokens=4096, latents=512, head_dim=128)
PDE_SHAPE = MixerShape(batch=1, heads=8, tokens=4096, latents=2048, head_dim=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qkv(b=2, h=3, n=32, m=8, d=8, scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((h, m, d)) * scale).astype(np.float32),
            (rng.standard_normal((b, h, n, d)) * scale).astype(np.float32),
            rng.standard_normal((b, h, n, d)).astype(np.float32))


def _both(arrays):
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# --- nn: rmsnorm, swiglu, embedding ------------------------------------------


def test_rmsnorm_swiglu_embedding_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    norm = tm.init_rmsnorm(32)
    load_jax_params(norm, {"scale": scale})
    for eps in (1e-6, 1e-5):
        want = jm.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), eps=eps)
        _close(tm.rmsnorm(norm, torch.from_numpy(x), eps=eps).detach(), want, 1e-6)
    jp = jm.init_swiglu(jax.random.PRNGKey(2), 32, 48)
    mlp = load_jax_params(tm.init_swiglu(32, 48, generator=torch.Generator().manual_seed(0)),
                          _np(jp))
    _close(tm.swiglu(mlp, torch.from_numpy(x)).detach(), jm.swiglu(jp, jnp.asarray(x)), 1e-6)
    je = jm.init_embedding(jax.random.PRNGKey(3), 40, 32)
    emb = load_jax_params(tm.init_embedding(40, 32, generator=torch.Generator().manual_seed(0)),
                          _np(je))
    ids = rng.integers(0, 40, (3, 5))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tm.embedding(emb, torch.from_numpy(ids), dtype).detach().float()
        _close(got, jnp.asarray(jm.embedding(je, jnp.asarray(ids), jdt), jnp.float32), 1e-6)


def test_lm_modules_init_like_jax():
    """Same names and shapes as the JAX tree, unstacked; RMSNorm scales 1."""
    jc, tc = jget_smoke("flare_lm"), get_smoke_config("flare_lm")
    jp = _np(jget_model(jc).init(jax.random.PRNGKey(0)))
    net = get_model(tc, device="cpu").init(0)
    from repro_torch.interop import params_from_jax

    want = {k: tuple(v.shape) for k, v in params_from_jax(unstack_layers(jp)).items()}
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == want
    assert net.embed.table.shape == (256, 64)     # vocab 128 pads to 256 rows
    assert torch.equal(net.layers[1].norm2.scale, torch.ones(64))


# --- core/flare_stream ---------------------------------------------------------


def test_stream_append_matches_jax():
    q, k, v = _qkv(n=3)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    js = jfs.stream_init(2, 3, 8, 8)
    ts = tfs.stream_init(2, 3, 8, 8)
    for t in range(3):
        js, jy = jfs.stream_append(js, jq, jk[:, :, t], jv[:, :, t])
        ts, ty = tfs.stream_append(ts, tq, tk[:, :, t], tv[:, :, t])
        _close(ty, jy, 1e-5)
    for a, b in zip(ts, js):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("step", ["stream_chunk", "stream_chunk_factored"])
def test_stream_chunk_matches_jax(step, masked):
    """One chunk on a carried state, with and without a padding mask."""
    q, k, v = _qkv(n=13, seed=2)
    mask = np.arange(13)[None, :] < np.array([[13], [9]]) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    js, _ = jax.jit(jfs.stream_chunk)(jfs.stream_init(2, 3, 8, 8), jq, jk[:, :, :5], jv[:, :, :5])
    ts, _ = tfs.stream_chunk(tfs.stream_init(2, 3, 8, 8), tq, tk[:, :, :5], tv[:, :, :5])
    js, jy = jax.jit(getattr(jfs, step))(js, jq, jk[:, :, 5:], jv[:, :, 5:],
                                         mask=None if mask is None else jnp.asarray(mask[:, 5:]))
    ts, ty = getattr(tfs, step)(ts, tq, tk[:, :, 5:], tv[:, :, 5:],
                                mask=None if mask is None else torch.from_numpy(mask[:, 5:]))
    _close(ty, jy, 1e-5)
    for a, b in zip(ts, js):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("mode", ["factored", "exact"])
def test_flare_causal_with_state_matches_jax_and_oracle(mode):
    q, k, v = _qkv(n=24, seed=3)
    lengths = np.array([24, 17])
    mask = np.arange(24)[None, :] < lengths[:, None]
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    # chunk 16 does not divide 24: both halve it to 8
    js, jy = jfs.flare_causal_with_state(jq, jk, jv, chunk_size=16, mode=mode,
                                         mask=jnp.asarray(mask))
    ts, ty = tfs.flare_causal_with_state(tq, tk, tv, chunk_size=16, mode=mode,
                                         mask=torch.from_numpy(mask))
    _close(ty, jy, 1e-5)
    for a, b in zip(ts, js):
        _close(a, b, 1e-5)
    y_ref = tfs.flare_causal_ref(tq, tk, tv)
    _close(tfs.flare_causal(tq, tk, tv, chunk_size=8, mode=mode), y_ref, 1e-5)
    _close(y_ref, jfs.flare_causal_ref(jq, jk, jv), 1e-5)
    # the masked state is the state of the unpadded prefix
    s17, _ = tfs.flare_causal_with_state(tq[:, :, :], tk[1:, :, :17], tv[1:, :, :17],
                                         chunk_size=8, mode=mode)
    for a, b in zip(ts, s17):
        _close(a[1:], b, 1e-5)


def test_decode_loop_equals_chunked():
    """The token-by-token serving path equals the chunked path."""
    q, k, v = map(torch.from_numpy, _qkv(n=16, seed=4))
    state = tfs.stream_init(2, 3, 8, 8)
    outs = []
    for t in range(16):
        state, y = tfs.stream_append(state, q, k[:, :, t], v[:, :, t])
        outs.append(y)
    st_chunk, y_chunk = tfs.flare_causal_with_state(q, k, v, chunk_size=8)
    _close(torch.stack(outs, dim=2), y_chunk, 1e-5)
    for a, b in zip(state, st_chunk):
        _close(a, b, 1e-5)


def test_exact_path_is_causal_under_adversarial_future():
    q, k, v = map(torch.from_numpy, _qkv(n=16, seed=5))
    y = tfs.flare_causal(q, k, v, chunk_size=8, mode="exact")
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 10:] *= 50.0
    v2[:, :, 10:] = 1e4
    y2 = tfs.flare_causal(q, k2, v2, chunk_size=8, mode="exact")
    _close(y2[:, :, :10], y[:, :, :10], 1e-5)


# --- the causal kernel's plain version against the Pallas kernel ----------------


@pytest.mark.parametrize("b,h,n,m,d", [(1, 2, 64, 16, 8), (2, 1, 97, 16, 8), (1, 2, 130, 8, 16),
                                         (1, 2, 70, 8, 24), (1, 1, 66, 8, 96)])
def test_flare_causal_fused_matches_pallas(b, h, n, m, d):
    """The port's wrapper on CPU tensors (the plain version at the kernel's
    tile) against the Pallas kernel in interpret mode (tile 32, N padded, D
    padded to 128 lanes), ragged N and the head dims the kernel runs at a
    padded width (24, phi3's 96) included; no kernel is launched."""
    q, k, v = _qkv(b, h, n, m, d, seed=6)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    before = launch_counts()
    want = jflare_causal_fused(jq, jk, jv, tile=32, interpret=True)
    _close(flare_causal_fused(tq, tk, tv), want, 2e-5)
    jb, tb = (x.astype(jnp.bfloat16) for x in (jq, jk, jv)), (x.bfloat16() for x in (tq, tk, tv))
    got16 = flare_causal_fused(*tb)
    assert got16.dtype == torch.bfloat16
    want16 = jflare_causal_fused(*jb, tile=32, interpret=True)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               atol=3e-2, rtol=3e-2)
    assert launch_counts() == before


# --- the model -------------------------------------------------------------------


def _models(compute_dtype, **policy):
    jc = dataclasses.replace(jget_smoke("flare_lm"), compute_dtype=compute_dtype)
    tc = replace(get_smoke_config("flare_lm"), compute_dtype=compute_dtype)
    jmod = jget_model(jc)
    jp = jmod.init(jax.random.PRNGKey(0))
    tmod = get_model(tc, device="cpu", policy=MixerPolicy(**policy) if policy else None)
    net = load_jax_params(tmod.init(0), unstack_layers(_np(jp)))
    return jmod, jp, tmod, net


def _tokens(b, s, seed=7):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


@pytest.mark.parametrize("backend", ["causal_stream", "causal_pallas"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(compute_dtype, backend):
    jmod, jp, tmod, net = _models(compute_dtype, backends=(backend,))
    assert tmod.plans["infer"].backend == backend
    toks = _tokens(2, 21)
    want, _ = jmod.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tmod.forward(net, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 21, 128) and got.dtype == torch.float32 and aux.item() == 0
    want = np.asarray(want, np.float32)
    tol = 1e-4 if compute_dtype == "float32" else 2e-2 * np.abs(want).max()
    _close(got, want, tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(compute_dtype):
    """Prefill of a right-padded bucket with lengths, then greedy decode
    steps, against the JAX package on the same weights; in fp32 the greedy
    tokens are the same."""
    jmod, jp, tmod, net = _models(compute_dtype)
    toks = _tokens(3, 16, seed=8)
    lengths = np.array([16, 9, 12], np.int32)
    toks[np.arange(16)[None, :] >= lengths[:, None]] = 0
    jl, jc = jax.jit(jmod.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)}, 64)
    tl, tc = tmod.prefill(net, {"tokens": torch.from_numpy(toks).long(),
                                "lengths": torch.from_numpy(lengths)}, 64)
    assert tc.pos.tolist() == lengths.tolist() and len(tc.layers) == 2
    f32 = compute_dtype == "float32"
    tol = lambda w: 1e-4 if f32 else 2e-2 * np.abs(np.asarray(w)).max()
    _close(tl, jl, tol(jl))
    jtok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    ttok = tl.argmax(-1, keepdim=True)
    jdecode = jax.jit(jmod.decode_step)
    for step in range(4):
        if f32:
            assert ttok.numpy().tolist() == jtok.tolist()
        jl, jc = jdecode(jp, jnp.asarray(jtok), jc)
        tl, tc = tmod.decode_step(net, torch.from_numpy(jtok).long(), tc)
        assert tl.shape == (3, 128)
        _close(tl, jl, tol(jl))
        jtok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        ttok = tl.argmax(-1, keepdim=True)
    assert tc.pos.tolist() == (lengths + 4).tolist()
    if f32:   # the carried states, layer by layer (JAX stacks them; num is unnormalised)
        for i, ts in enumerate(tc.layers):
            for a, b in zip(ts, jc.layers):
                _close(a, b[i], 1e-5 * max(1.0, float(np.abs(np.asarray(b[i])).max())))


def test_decode_continues_forward():
    """Prefill then decode equals the forward of the whole sequence (the
    plain path) position by position, and init_caches gives fresh states."""
    _, _, tmod, net = _models("float32")
    toks = torch.from_numpy(_tokens(2, 12, seed=9)).long()
    logits, caches = tmod.prefill(net, {"tokens": toks[:, :8]}, 64)
    steps = [logits]
    for t in range(8, 12):
        logits, caches = tmod.decode_step(net, toks[:, t:t + 1], caches)
        steps.append(logits)
    full, _ = tmod.forward(net, {"tokens": toks})
    _close(torch.stack(steps[:-1], dim=1), full[:, 7:11], 1e-5)
    fresh = tmod.init_caches(2, 64)
    assert fresh.pos.tolist() == [0, 0] and len(fresh.layers) == 2
    assert torch.isinf(fresh.layers[0].m_max).all() and fresh.layers[0].num.shape == (2, 4, 8, 16)


def test_loss_runs():
    """The loss trains under the causal_stream plan: a finite scalar whose
    gradient reaches every parameter, equal to JAX's (tests/test_torch_lm_train.py
    holds it and its gradients)."""
    jmod, jp, tmod, net = _models("float32")
    toks = _tokens(2, 17)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss = tmod.loss(net, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert tmod.plans["train"].backend == "causal_stream" and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(jmod.loss(jp, {k: jnp.asarray(v) for k, v
                                                                 in batch.items()})), rtol=1e-5)
    assert all(p.grad is not None and bool(p.grad.isfinite().all()) for p in net.parameters())


# --- data and configs -------------------------------------------------------------


def test_token_stream_matches_jax():
    for step, shard in ((0, 0), (3, 1)):
        want = JTokenStream(128, 33, seed=5).batch(step, shard, 2, 3)
        got = TokenStream(128, 33, seed=5).batch(step, shard, 2, 3)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(TokenStream(65536, 64).global_batch(1, 4, 2)["tokens"],
                                  JTokenStream(65536, 64).global_batch(1, 4, 2)["tokens"])


@pytest.mark.parametrize("smoke", [False, True])
def test_flare_lm_config_matches_jax(smoke):
    jc = (jget_smoke if smoke else jget_config)("flare_lm")
    tc = (get_smoke_config if smoke else get_config)("flare_lm")
    for f in ("name", "family", "num_layers", "d_model", "d_ff", "vocab", "norm", "norm_eps",
              "tie_embeddings", "param_dtype", "compute_dtype", "remat", "microbatch"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("kind", "num_heads", "num_kv_heads", "head_dim", "flare_latents", "flare_chunk"):
        assert getattr(tc.attn, f) == getattr(jc.attn, f), f
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.astuple(SHAPES[name]) == dataclasses.astuple(JSHAPES[name])


# --- the causal contract ------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_causal_contract(device):
    f32 = torch.float32
    for name in ("sdpa", "packed", "pallas", "materialized"):
        with pytest.raises(ValueError, match="not causal"):
            resolve(name, shape=LM_SHAPE, dtype=f32, device=device, causal=True)
    for name in ("causal_stream", "causal_pallas"):
        with pytest.raises(ValueError, match="causal contract"):
            resolve(name, shape=PDE_SHAPE, dtype=f32, device=device)
    with pytest.raises(ValueError, match="forward-only"):
        resolve_policy(MixerPolicy(backends=("causal_pallas",), requires_grad=True), LM_SHAPE,
                       device=device, causal=True)
    auto = resolve_policy(None, LM_SHAPE, torch.bfloat16, device=device, causal=True)
    assert auto.backend == ("causal_pallas" if device == "cuda" else "causal_stream")
    train = resolve_policy(MixerPolicy(requires_grad=True), LM_SHAPE, device=device, causal=True)
    assert train.backend == "causal_stream"
    pinned = resolve_policy(MixerPolicy(backends=("sdpa", "causal_stream")),
                            LM_SHAPE, device=device, causal=True)
    assert pinned.describe() == "causal_stream(chunk_size=256;mode=factored)"
    # the PDE path resolves as before
    assert resolve_policy(None, PDE_SHAPE, device=device).describe() == (
        "packed(block_n=1024;block_m=256)" if device == "cuda" else "sdpa")


def test_flare_lm_plans_on_cuda_need_no_card():
    m = get_model(get_config("flare_lm"), device="cuda")
    assert m.plans["infer"].describe() == "causal_pallas"
    assert m.plans["train"].describe() == "causal_stream(chunk_size=1024;mode=factored)"
    m = get_model(get_smoke_config("flare_lm"), device="cpu",
                  policy=MixerPolicy(backends=("causal_pallas",)))
    assert m.plans == {"infer": m.plans["infer"]} and m.plans["infer"].describe() == "causal_pallas"
    m = get_model(get_smoke_config("flare_lm"), device="cpu")
    assert m.plans["infer"].describe() == "causal_stream(chunk_size=8;mode=factored)"
