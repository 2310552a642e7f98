"""The port's PDE surrogate, model API and data against the JAX package.

The surrogate forward is held at atol 1e-4 (fp32 through several blocks),
from the same weights (carried over by ``repro_torch.interop``) and batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro.core.policy import MixerPolicy as JPolicy
from repro.data import pde_data as jdata
from repro.models import pde as jpde
from repro.models.api import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch.config import SHAPES, replace
from repro_torch.core.policy import MixerPolicy
from repro_torch.data import pde_data as tdata
from repro_torch.interop import load_jax_params, params_from_jax
from repro_torch.models import pde as tpde
from repro_torch.models.api import get_model


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(tcfg, jcfg, n, b=2, policy=None, seed=0):
    """JAX model + params, and the port's model with the same weights."""
    jm = jget_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = get_model(tcfg, device="cpu", policy=policy)
    net = load_jax_params(tm.init(seed), _np(jparams))
    rng = np.random.default_rng(seed)
    batch = {"x": rng.random((b, n, 3)).astype(np.float32),
             "y": rng.standard_normal((b, n, 1)).astype(np.float32)}
    return jm, jparams, tm, net, batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("backend", ["auto", "sdpa", "pallas", "packed"])
def test_smoke_forward_matches_jax(backend):
    jm, jparams, tm, net, batch = _pair(tconfigs.get_smoke_config("flare_pde"),
                                        jconfigs.get_smoke_config("flare_pde"), n=61,
                                        policy=MixerPolicy(backends=(backend,)))
    got = tm.forward(net, _t(batch))
    want = jm.forward(jparams, _j(batch))
    assert got.shape == (2, 61, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_full_width_forward_matches_jax():
    """C=64, H=8, M=2048 (the paper's width), 2 blocks, N=256."""
    tcfg = replace(tconfigs.get_config("flare_pde"), num_layers=2)
    jcfg = dataclasses.replace(jconfigs.get_config("flare_pde"), num_layers=2)
    jm, jparams, tm, net, batch = _pair(tcfg, jcfg, n=256, b=1,
                                        policy=MixerPolicy(backends=("packed",)))
    np.testing.assert_allclose(tm.forward(net, _t(batch)).numpy(),
                               np.asarray(jm.forward(jparams, _j(batch))), atol=1e-4)


def test_loss_matches_jax_and_trains_on_sdpa():
    jm, jparams, tm, net, batch = _pair(tconfigs.get_smoke_config("flare_pde"),
                                        jconfigs.get_smoke_config("flare_pde"), n=40)
    assert tm.plans["train"].backend == "sdpa"
    loss = tm.loss(net, _t(batch))
    np.testing.assert_allclose(loss.item(), float(jm.loss(jparams, _j(batch))), atol=1e-5)
    loss.backward()
    assert all(p.grad is not None and p.grad.isfinite().all() for p in net.parameters())


def test_surrogate_structure_matches_jax_tree():
    jp = _np(jpde.init_surrogate(jax.random.PRNGKey(0), "flare", in_dim=3, out_dim=1, dim=32,
                                 num_blocks=2, num_heads=4, num_latents=16))
    net = tpde.init_surrogate(in_dim=3, out_dim=1, dim=32, num_blocks=2, num_heads=4,
                              num_latents=16, generator=torch.Generator().manual_seed(0))
    assert ({k: tuple(v.shape) for k, v in net.state_dict().items()}
            == {k: tuple(v.shape) for k, v in params_from_jax(jp).items()})


def test_relative_l2_matches_jax():
    rng = np.random.default_rng(4)
    p, t = (rng.standard_normal((3, 50, 2)).astype(np.float32) for _ in range(2))
    t[1] = 0.0   # the clamp of a zero target norm
    np.testing.assert_allclose(tpde.relative_l2(torch.from_numpy(p), torch.from_numpy(t)).item(),
                               float(jpde.relative_l2(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6)


def test_configs_match_jax():
    for name in ("flare_pde",):
        for getter in ("get_config", "get_smoke_config"):
            t = getattr(tconfigs, getter)(name)
            j = getattr(jconfigs, getter)(name)
            for f in dataclasses.fields(t):
                tv, jv = getattr(t, f.name), getattr(j, f.name)
                if dataclasses.is_dataclass(tv):   # the port's own AttnConfig
                    for g in dataclasses.fields(tv):
                        assert getattr(tv, g.name) == getattr(jv, g.name), (getter, f.name, g.name)
                else:
                    assert tv == jv, (getter, f.name)
    for name, s in SHAPES.items():
        assert (s.seq_len, s.global_batch) == (JSHAPES[name].seq_len, JSHAPES[name].global_batch)


# --- data -------------------------------------------------------------------


def test_apply_operator_matches_jax():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((12, 12)).astype(np.float32)
    a = np.exp(rng.standard_normal((12, 12))).astype(np.float32)
    np.testing.assert_allclose(tdata._apply_operator(torch.from_numpy(u), torch.from_numpy(a)).numpy(),
                               np.asarray(jdata._apply_operator(jnp.asarray(u), jnp.asarray(a))),
                               rtol=1e-5, atol=1e-3)


def test_cg_solve_matches_jax_and_batches():
    rng = np.random.default_rng(6)
    a = np.exp(0.5 * rng.standard_normal((2, 10, 10))).astype(np.float32)
    f = np.ones((10, 10), np.float32)
    got = tdata._cg_solve(torch.from_numpy(a), torch.ones(2, 10, 10), iters=25)
    for i in range(2):
        want = jdata._cg_solve(jnp.asarray(a[i]), jnp.asarray(f), iters=25)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


def test_grf_filter_on_given_noise_matches_jax(monkeypatch):
    noise = np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)
    monkeypatch.setattr(jdata.jax.random, "normal", lambda key, shape: jnp.asarray(noise))
    want = jdata._grf(jax.random.PRNGKey(0), 16)
    got = tdata._grf_from_noise(torch.from_numpy(noise)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pointcloud_subsample_matches_jax():
    """Same Philox draw: the same grid nodes, whose (x, y) coordinates match exactly."""
    want = jdata.pointcloud_batch(3, 2, 2, grid=8, num_points=20, cg_iters=2)["x"]
    got = tdata.pointcloud_batch(3, 2, 2, grid=8, num_points=20, cg_iters=2, device="cpu")["x"]
    np.testing.assert_array_equal(got[..., :2].numpy(), np.asarray(want)[..., :2])


def test_darcy_batch_deterministic_and_solved():
    a = tdata.darcy_batch(1, 0, 2, grid=12, cg_iters=60, device="cpu")
    b = tdata.darcy_batch(1, 0, 2, grid=12, cg_iters=60, device="cpu")
    c = tdata.darcy_batch(1, 1, 2, grid=12, cg_iters=60, device="cpu")
    assert a["x"].shape == (2, 144, 3) and a["y"].shape == (2, 144, 1)
    assert torch.equal(a["x"], b["x"]) and not torch.equal(a["x"], c["x"])
    assert a["y"].abs().amax(dim=(1, 2)).allclose(torch.ones(2))   # normalised target
    coef = a["x"][0, :, 2].reshape(12, 12)
    u = a["y"][0, :, 0].reshape(12, 12)
    r = tdata._apply_operator(u, coef) - tdata._apply_operator(u, coef).mean()
    assert r.std() < 0.05 * tdata._apply_operator(u, coef).abs().mean()   # A u = const
