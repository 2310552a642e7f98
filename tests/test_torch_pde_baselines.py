"""The port's Table-1 mixers (FLARE and the four baselines) against the JAX package.

A small size (C=32, 4 heads, 16 latents, 2 blocks, B=2, N=97 and 64), inputs
from numpy with a seed, weights carried over from the JAX tree by
``repro_torch.interop``. Tolerances: fp32 outputs 1e-5; the loss 1e-5 and
every gradient 1e-4 of its leaf's max |g| (leaves whose exact gradient is
zero, below, against the tree's max |g|); three AdamW updates 1e-5 over
every parameter but the key biases (see the test); the SDPA route against
the plain ``sdpa`` 1e-6; ``gelu_mlp`` 1e-6.

Two kinds of leaf have an exact gradient of zero, so their computed
gradients are rounding noise in both packages: a key bias (``wk.bias``: a
shift of every key by one vector moves a query's scores by one constant,
which the softmax cancels) and the Perceiver's ``enc``/``dec`` ``ln2`` and
``mlp``, which no path reads (the port gives them zeros, as ``jax.grad``
does).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import TrainConfig as JTrainConfig
from repro.data import pde_data as jdata
from repro.models import pde as jpde
from repro.nn import modules as jnn
from repro.optim.adamw import init_adamw as jinit_adamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.config import TrainConfig
from repro_torch.core.flare import sdpa
from repro_torch.data import pde_data as tdata
from repro_torch.interop import from_jax_flat, load_jax_params, params_from_jax, to_jax_flat
from repro_torch.models import pde as tpde
from repro_torch.nn import modules as tnn
from repro_torch.optim import init_adamw
from repro_torch.train import make_train_step

MIXERS = ("flare", "vanilla", "perceiver", "linformer", "transolver")
SIZE = dict(in_dim=3, out_dim=1, dim=32, num_blocks=2, num_heads=4, num_latents=16)
HEADS = SIZE["num_heads"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(mixer, seed=0):
    """The JAX surrogate's params, and the port's surrogate with the same weights."""
    jparams = jpde.init_surrogate(jax.random.PRNGKey(seed), mixer, **SIZE)
    net = tpde.init_surrogate(mixer, generator=torch.Generator().manual_seed(seed), **SIZE)
    return jparams, load_jax_params(net, _np(jparams))


def _batch(n, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((b, n, 3)).astype(np.float32),
            "y": rng.standard_normal((b, n, 1)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _zero_grad_leaf(name):
    return name.endswith("wk.bias") or any(
        name.startswith(f"perceiver.{p}.{leaf}") for p in ("enc", "dec") for leaf in ("ln2", "mlp"))


@pytest.mark.parametrize("n", [97, 64])
@pytest.mark.parametrize("mixer", MIXERS)
def test_surrogate_forward_matches_jax(mixer, n):
    jparams, net = _pair(mixer)
    batch = _batch(n)
    got = tpde.surrogate_forward(net, torch.from_numpy(batch["x"]), mixer=mixer, num_heads=HEADS)
    want = jax.jit(functools.partial(jpde.surrogate_forward, mixer=mixer, num_heads=HEADS))(
        jparams, jnp.asarray(batch["x"]))
    assert got.shape == (2, n, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mixer", MIXERS)
def test_surrogate_loss_and_grads_match_jax(mixer):
    jparams, net = _pair(mixer)
    batch = _batch(97)
    loss = tpde.surrogate_loss(net, _t(batch), mixer=mixer, num_heads=HEADS)
    loss.backward()
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpde.surrogate_loss(p, _j(batch), mixer=mixer, num_heads=HEADS)))(jparams)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    want = params_from_jax(_np(jgrads))
    assert sorted(want) == sorted(k for k, _ in net.named_parameters())
    tree_max = max(g.abs().max().item() for g in want.values())
    for name, p in net.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = tree_max if _zero_grad_leaf(name) else want[name].abs().max().item()
        assert scale > 0, name
        err = (got - want[name]).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("mixer", MIXERS)
def test_state_dict_is_the_jax_tree(mixer):
    """Keys and shapes are the JAX leaf paths (dense kernels transposed, the
    Linformer's ``proj_e`` and the Perceiver's ``latents`` as they are); a
    strict load of the JAX tree fills every parameter."""
    jparams = _np(jpde.init_surrogate(jax.random.PRNGKey(1), mixer, **SIZE))
    net = tpde.init_surrogate(mixer, generator=torch.Generator().manual_seed(1), **SIZE)
    want = params_from_jax(jparams)
    assert ({k: tuple(v.shape) for k, v in net.state_dict().items()}
            == {k: tuple(v.shape) for k, v in want.items()})
    load_jax_params(net, jparams)
    flat = _flat_jax(jparams)
    if mixer == "perceiver":
        np.testing.assert_array_equal(net.perceiver.latents.detach().numpy(),
                                      flat["perceiver/latents"])
    if mixer == "linformer":
        assert net.blocks[0].proj_e.shape == (tpde.MAX_TOKENS, 16)
        np.testing.assert_array_equal(net.blocks[1].proj_e.detach().numpy(),
                                      flat["blocks/1/proj_e"])
    if mixer == "transolver":
        np.testing.assert_array_equal(net.blocks[0].slice_proj.weight.detach().numpy(),
                                      flat["blocks/0/slice_proj/kernel"].T)
    if mixer != "flare":
        block = net.perceiver.enc if mixer == "perceiver" else net.blocks[0]
        prefix = "perceiver/enc" if mixer == "perceiver" else "blocks/0"
        np.testing.assert_array_equal(block.mlp.w_up.weight.detach().numpy(),
                                      flat[f"{prefix}/mlp/w_up/kernel"].T)


@pytest.mark.parametrize("mixer", MIXERS)
def test_checkpoint_leaves_round_trip(mixer):
    """``to_jax_flat`` writes the JAX leaf paths and arrays, and
    ``from_jax_flat`` gives the state dict back, so either package restores
    the other's checkpoint."""
    jparams, net = _pair(mixer, seed=2)
    flat = to_jax_flat(net.state_dict())
    want = _flat_jax(jparams)
    assert sorted(flat) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(flat[key], arr, err_msg=key)
    back = from_jax_flat(flat)
    for name, t in net.state_dict().items():
        assert torch.equal(back[name], t), name


def test_linformer_refuses_more_tokens_than_its_projection():
    block = tpde.init_linformer_block(32, 4, 16, generator=torch.Generator().manual_seed(0),
                                      max_tokens=64)
    x = torch.zeros(1, 64, 32)
    assert tpde.linformer_block(block, x, 4).shape == x.shape
    with pytest.raises(ValueError, match="at most 64 tokens"):
        tpde.linformer_block(block, torch.zeros(1, 65, 32), 4)
    jblock = jpde.init_linformer_block(jax.random.PRNGKey(0), 32, 4, 16, max_tokens=64)
    with pytest.raises(Exception):   # the reference fails on the projection's shape
        jpde.linformer_block(jblock, jnp.zeros((1, 65, 32)), 4)
    _, net = _pair("linformer")
    with pytest.raises(ValueError, match=f"at most {tpde.MAX_TOKENS} tokens"):
        tpde.surrogate_forward(net, torch.zeros(1, tpde.MAX_TOKENS + 1, 3), mixer="linformer",
                               num_heads=HEADS)


def test_gelu_mlp_matches_jax_with_the_tanh_gelu():
    """atol 1e-6; the exact (erf) GELU misses that limit on the same weights."""
    jp = _np(jnn.init_gelu_mlp(jax.random.PRNGKey(3), 16, 64))
    mlp = tnn.init_gelu_mlp(16, 64, generator=torch.Generator().manual_seed(3))
    load_jax_params(mlp, jp)
    x = np.random.default_rng(3).standard_normal((2, 33, 16)).astype(np.float32)
    want = np.asarray(jnn.gelu_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)))
    got = tnn.gelu_mlp(mlp, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    erf = tnn.dense(mlp.w_down, F.gelu(tnn.dense(mlp.w_up, torch.from_numpy(x))))
    assert np.abs(erf.detach().numpy() - want).max() > 1e-6
    assert tnn.count_params(mlp) == jnn.count_params(jp) == 16 * 64 * 2 + 64 + 16


def test_darcy_dataset_matches_jax(monkeypatch):
    """A list of num // batch batches, each ``darcy_batch(seed, i, batch)``;
    with the port's GRF noise replaced by JAX's draws for the same (seed,
    index), each batch equals the JAX dataset's (the solver and the features
    in fp32, 1e-4 of the normalised target)."""
    seed, num, batch, grid, iters = 5, 4, 2, 8, 20
    got = tdata.darcy_dataset(seed, num, grid=grid, batch=batch, cg_iters=iters, device="cpu")
    assert len(got) == num // batch
    for i, b in enumerate(got):
        again = tdata.darcy_batch(seed, i, batch, grid=grid, cg_iters=iters, device="cpu")
        for k in ("x", "y"):
            assert isinstance(b[k], np.ndarray)
            np.testing.assert_array_equal(b[k], again[k].numpy())
    draws = iter(range(num))

    def jax_noise(generator, n, *, batch=1, alpha=3.0, device=None):
        noise = []
        for _ in range(batch):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), next(draws))
            noise.append(np.asarray(jax.random.normal(jax.random.split(key)[0], (n, n))))
        return tdata._grf_from_noise(torch.from_numpy(np.stack(noise)).to(device), alpha=alpha)

    monkeypatch.setattr(tdata, "_grf", jax_noise)
    got = tdata.darcy_dataset(seed, num, grid=grid, batch=batch, cg_iters=iters, device="cpu")
    want = jdata.darcy_dataset(seed, num, grid=grid, batch=batch, cg_iters=iters)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["x"], w["x"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["y"], w["y"], atol=1e-4)


@pytest.mark.parametrize("s,t", [(97, 97), (16, 97), (97, 16), (64, 64)])
def test_sdpa_route_matches_plain_sdpa(s, t):
    """``F.scaled_dot_product_attention`` against the reference's plain
    ``sdpa`` in fp32, at the shapes the mixers give it: self-attention, the
    latents over the tokens and back; and the baselines' route
    (``pde.attention``, which centres the keys first) against the plain
    route in fp64."""
    rng = np.random.default_rng(s * 1000 + t)
    q = torch.from_numpy(rng.standard_normal((2, 4, s, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 4, t, 8)).astype(np.float32))
            for _ in range(2))
    torch.testing.assert_close(F.scaled_dot_product_attention(q, k, v, scale=8 ** -0.5),
                               sdpa(q, k, v, scale=8 ** -0.5), atol=1e-6, rtol=0)
    want = tpde.plain_attention(q.double(), k.double(), v.double())
    torch.testing.assert_close(tpde.attention(q, k, v).double(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mixer", MIXERS)
def test_train_steps_match_jax(mixer):
    """AdamW steps with weight decay (1e-1, so that the decay shows in
    fp32): the JAX ``make_train_step`` against the port's on the same
    weights, every parameter at 1e-5, the Perceiver's unread ones included
    (decayed, not left as they were); the losses at 1e-4 relative, as
    ``test_torch_train.py`` holds FLARE's (fp32 sums in another order, which
    the random-init surrogate amplifies: 7e-5 at FLARE's fourth step with
    its parameters 7e-6 apart). The schedule's step 0 has lr 0, so four
    steps make three updates.

    A key bias is the exception. Its exact gradient is zero and it starts at
    zero, so its exact trajectory stays at zero; in both packages AdamW
    divides its rounding noise by the noise's own RMS and moves it by up to
    about lr a step (6e-5 apart after these steps). Each package's key bias
    is held within the summed lr of zero instead: a bound any AdamW path
    from zero meets, so it is no check of the key bias. Its real check is
    ``test_surrogate_loss_and_grads_match_jax``, which holds its gradient
    to 1e-4 of the tree's max |g|."""
    jparams, net = _pair(mixer, seed=4)
    init = {k: p.detach().clone() for k, p in net.named_parameters()}
    kw = dict(steps=10, learning_rate=1e-3, warmup_frac=0.2, weight_decay=1e-1, grad_clip=1.0)
    jloss = lambda p, b: jpde.surrogate_loss(p, b, mixer=mixer, num_heads=HEADS)
    tloss = lambda m, b: tpde.surrogate_loss(m, b, mixer=mixer, num_heads=HEADS)
    jstep = jax.jit(jmake_train_step(jloss, JTrainConfig(**kw)))
    tstep = make_train_step(tloss, TrainConfig(**kw))
    jopt, topt = jinit_adamw(jparams), init_adamw(dict(net.named_parameters()))
    lr_sum = 0.0
    for i in range(4):
        batch = _batch(64, seed=10 + i)
        jparams, jopt, jmet = jstep(jparams, jopt, _j(batch))
        net, topt, tmet = tstep(net, topt, _t(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        lr_sum += tmet["lr"]
    assert lr_sum > 0
    want = params_from_jax(_np(jparams))
    for name, p in net.named_parameters():
        if name.endswith("wk.bias"):
            for b in (p.detach(), want[name]):
                assert b.abs().max().item() <= lr_sum, name
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
    if mixer == "perceiver":
        for name in ("perceiver.enc.mlp.w_up.weight", "perceiver.dec.ln2.scale"):
            p = dict(net.named_parameters())[name]
            assert not torch.equal(p.detach(), init[name]), name
            assert p.grad is None
