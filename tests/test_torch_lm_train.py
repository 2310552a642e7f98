"""Training the port's LMs (``flare_lm`` and the dense family: qwen2, phi3)
against the JAX package: ``lm_loss``, its gradients and activation
checkpointing. The train step, the trainer, checkpoints in the stacked
layout and the launcher are in ``tests/test_torch_lm_train_loop.py``.

Inputs are drawn with numpy from a seed and given to both packages; weights
are carried from the JAX tree (``interop``). Tolerances: the loss 1e-5
relative in fp32 compute and 2e-2 in bf16 (``tests/test_kernels.py``); every
parameter's gradient 1e-4 absolute and relative (two layers and a head of
fp32 sums in another order); ``flare_causal``'s gradients 1e-5 of their
largest magnitude (``tests/test_flare_stream.py``'s 1e-5 on the mixer);
the checkpointing modes against each other exactly (the same kernels
recomputed on the CPU)."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import flare_stream as jfs
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.api import get_model as jget_model
from repro_torch.config import replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import flare_stream as tfs
from repro_torch.core.dispatch import MixerShape
from repro_torch.core.policy import MixerPolicy, resolve_policy
from repro_torch.data.synthetic import TokenStream
from repro_torch.interop import load_jax_params, params_from_jax, unstack_layers
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.api import get_model

ARCHS = ("flare_lm", "qwen2_1_5b", "phi3_mini_3_8b")
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LM_SHAPE = MixerShape(batch=1, heads=16, tokens=4096, latents=512, head_dim=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, compute_dtype="float32", remat="none", **policy):
    """The JAX smoke LM with its params, and the port's with the same weights."""
    jc = dataclasses.replace(jget_smoke(arch), compute_dtype=compute_dtype)
    tc = replace(get_smoke_config(arch), compute_dtype=compute_dtype, remat=remat)
    jm = jget_model(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(tc, device="cpu", policy=MixerPolicy(**policy) if policy else None)
    return jc, jm, jp, tc, tm, load_jax_params(tm.init(0), unstack_layers(_np(jp)))


def _batch(b=2, s=24, seed=3, vocab=128):
    """A TokenStream batch: int32 tokens and labels, numpy."""
    return TokenStream(vocab, s, seed=seed).global_batch(seed, b, 1)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(tm, net, batch, **kw):
    """(loss, {parameter name: gradient}) through the port's training route."""
    for p in net.parameters():
        p.grad = None
    loss = (tt.lm_loss(net, _t(batch), tm.cfg, **kw) if kw else tm.loss(net, _t(batch)))
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


# --- the loss and its gradients against JAX ----------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch, compute_dtype):
    _, jm, jp, _, tm, net = _pair(arch, compute_dtype)
    batch = _batch()
    got = tm.loss(net, _t(batch))
    want = float(jm.loss(jp, _j(batch)))
    assert got.requires_grad and got.dtype == torch.float32 and got.dim() == 0
    assert math.isclose(got.item(), want, rel_tol=LOSS_TOL[compute_dtype]), (got.item(), want)


@pytest.mark.parametrize("arch,impl,seq", [("flare_lm", "auto", 24), ("qwen2_1_5b", "xla", 24),
                                           ("qwen2_1_5b", "chunked", 520),
                                           ("phi3_mini_3_8b", "xla", 24)])
def test_lm_grads_match_jax(arch, impl, seq):
    """Every parameter's gradient against jax.grad(lm_loss), the JAX tree
    unstacked; the chunked route at 520 tokens runs two query blocks of 512,
    the last ragged."""
    jc, _, jp, tc, tm, net = _pair(arch)
    batch = _batch(b=1 if seq > 100 else 2, s=seq)
    if arch == "flare_lm":
        jloss = lambda p: jget_model(jc).loss(p, _j(batch))
        loss, grads = _grads(tm, net, batch)
    else:
        jloss = lambda p: jt.lm_loss(p, _j(batch), jc, impl=impl)
        loss, grads = _grads(tm, net, batch, impl=impl)
    want_loss, jgrads = jax.value_and_grad(jloss)(jp)
    assert math.isclose(loss.item(), float(want_loss), rel_tol=1e-5)
    want = params_from_jax(unstack_layers(_np(jgrads)))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        assert bool(g.isfinite().all()), name
        torch.testing.assert_close(g, want[name], atol=1e-4, rtol=1e-4, msg=name)


def _causal_operands(scale, n):
    rng = np.random.default_rng(11)
    b, h, m, d = 2, 3, 8, 16
    q = (rng.standard_normal((h, m, d)) * scale / math.sqrt(d)).astype(np.float32)
    k, v, dy = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    return q, k, v, dy


@functools.cache
def _jax_causal_grads(scale, n, chunk, mode):
    """jax.grad of sum(flare_causal * dy) in q, k, v (shared by both modes'
    cases: the exact form's is the reference of each)."""
    q, k, v, dy = _causal_operands(scale, n)
    jf = lambda *a: jnp.sum(jfs.flare_causal(*a, chunk_size=chunk, mode=mode) * dy)
    return [np.asarray(g) for g in jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("mode", ["factored", "exact"])
@pytest.mark.parametrize("scale,n,chunk", [(30.0, 64, 16), (0.5, 104, 32)])
def test_flare_causal_grads_match_jax(scale, n, chunk, mode):
    """flare_causal's gradients, finite, against jax.grad: scores of scale
    30 (future scores tens of nats above a token's, past the factored
    form's bounded-score contract) and N=104, which no power-of-two chunk of
    32 divides (the scan steps in chunks of 8). The JAX factored gradient is
    NaN at scale 30 (d F2 / d cden overflows fp32); the port's is held
    against it where it is finite and against the JAX exact form's
    everywhere."""
    q, k, v, dy = _causal_operands(scale, n)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tfs.flare_causal(*ts, chunk_size=chunk, mode=mode) * torch.from_numpy(dy)).sum().backward()
    exact = _jax_causal_grads(scale, n, chunk, "exact")
    same = _jax_causal_grads(scale, n, chunk, mode)
    for name, t, w, e in zip(("dq", "dk", "dv"), ts, same, exact):
        got = t.grad.numpy()
        assert np.isfinite(got).all() and np.isfinite(e).all(), name
        tol = 1e-5 * np.abs(e).max()
        ok = np.isfinite(w)
        assert ok.all() or (mode == "factored" and scale == 30.0), name
        np.testing.assert_allclose(got[ok], w[ok], atol=tol, rtol=0, err_msg=name)
        np.testing.assert_allclose(got, e, atol=tol, rtol=0, err_msg=name)


def test_safe_exp_has_no_nan_gradient():
    """The all-masked case (-inf against -inf) gives 0 and a 0 gradient."""
    a = torch.tensor([-math.inf, -math.inf, 0.5], requires_grad=True)
    m = torch.tensor([-math.inf, 1.0, 1.0], requires_grad=True)
    y = tfs._safe_exp(a, m)
    y.sum().backward()
    assert y.tolist()[:2] == [0.0, 0.0]
    assert a.grad.isfinite().all() and m.grad.isfinite().all()
    assert a.grad.tolist()[:2] == [0.0, 0.0] and m.grad.tolist()[:2] == [0.0, 0.0]


def test_chunked_attention_grads_on_masked_rows():
    """attn_sdpa's chunked route with rows that see no key (Sq 128 over Skv
    64, a window of 24: rows >= 87), blocks of 32: the output and every
    gradient equal the JAX route's, and the masked rows give 0, not NaN."""
    rng = np.random.default_rng(5)
    q, k, v, dy = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, 2, 128, 8), (1, 2, 64, 8), (1, 2, 64, 8), (1, 2, 128, 8)))
    kw = dict(scale=8 ** -0.5, causal=True, window=24, impl="chunked", chunk=32)

    def jf(*a):
        return jnp.sum(jattn.attn_sdpa(*a, **kw) * dy)

    want_y = np.asarray(jattn.attn_sdpa(*map(jnp.asarray, (q, k, v)), **kw))
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    y = tattn.attn_sdpa(*ts, **kw)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5)
    assert not y[:, :, 87:].any() and not ts[0].grad[:, :, 87:].any()
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert bool(t.grad.isfinite().all()), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_flash_route_refuses_autograd():
    q, k, v = (torch.randn(1, 2, 16, 8, requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="forward-only"):
        tattn.attn_sdpa(q, k, v, scale=0.35, impl="pallas")


# --- plans: training never lands on a forward-only kernel ---------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_train_plan_is_causal_stream(device):
    plan = resolve_policy(None, LM_SHAPE, torch.bfloat16, device=device, requires_grad=True,
                          causal=True)
    assert plan.backend == "causal_stream"
    with pytest.raises(ValueError, match="forward-only"):
        resolve_policy(MixerPolicy(backends=("causal_pallas",)), LM_SHAPE, torch.bfloat16,
                       device=device, requires_grad=True, causal=True)
    m = get_model(get_config("flare_lm"), device=device)
    assert m.plans["train"].describe() == "causal_stream(chunk_size=1024;mode=factored)"


def test_loss_under_forward_only_policy_raises():
    """A model built for inference only (causal_pallas alone) serves, and its
    loss raises the resolve error, as the JAX package's _train_guard does."""
    _, _, _, _, tm, net = _pair("flare_lm", backends=("causal_pallas",))
    assert "train" not in tm.plans
    tm.forward(net, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    with pytest.raises(ValueError, match="inference-only.*forward-only"):
        tm.loss(net, _t(_batch()))


# --- activation checkpointing ---------------------------------------------------


@pytest.mark.parametrize("arch", ["flare_lm", "qwen2_1_5b"])
def test_remat_modes_agree(arch):
    """none / full / dots: the same loss and gradients, bit for bit (the
    recomputation runs the same CPU kernels on the same inputs), and the
    forward under no_grad unchanged."""
    batch = _batch(b=2, s=24)
    out = {}
    for remat in ("none", "full", "dots"):
        _, _, _, tc, tm, net = _pair(arch, remat=remat)
        out[remat] = _grads(tm, net, batch)
        with torch.no_grad():
            out[remat] += (tt.lm_forward(net, _t(batch)["tokens"], tc,
                                         plan=tm.plans.get("infer"))[0],)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][2], out["none"][2]), remat
        for name, g in out[remat][1].items():
            assert torch.equal(g, out["none"][1][name]), (remat, name)


def test_remat_full_keeps_only_layer_inputs():
    """Under "full" the backward's saved tensors are the layers' inputs and
    what the embedding and head keep, far fewer than without it."""
    batch = _batch(b=2, s=24)
    counts = {}
    for remat in ("none", "full"):
        _, _, _, _, tm, net = _pair("qwen2_1_5b", remat=remat)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            tm.loss(net, _t(batch))
        counts[remat] = len(saved)
    assert counts["full"] * 3 < counts["none"], counts
    with pytest.raises(ValueError, match="remat"):
        tt._remat(lambda x: x, "some")
