"""The port's nn modules against the JAX package's, on the same weights.

Weights are made by the JAX initialisers and carried over with
``repro_torch.interop``; inputs come from numpy. Tolerance atol 1e-6 (fp32,
one to a few small matmuls), with rtol 1e-6 for the wider activations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import modules as jm
from repro_torch.interop import load_jax_params, params_from_jax
from repro_torch.nn import modules as tm

TOL = dict(atol=1e-6, rtol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("use_bias", [False, True])
def test_dense_matches_jax(use_bias):
    rng = np.random.default_rng(0)
    p = jm.init_dense(jax.random.PRNGKey(0), 5, 7, use_bias=use_bias)
    if use_bias:
        p["bias"] = jnp.asarray(rng.standard_normal(7), jnp.float32)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    layer = load_jax_params(tm.init_dense(5, 7, generator=_gen(), use_bias=use_bias), _np(p))
    np.testing.assert_allclose(tm.dense(layer, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.dense(p, jnp.asarray(x))), **TOL)


def test_dense_weight_is_kernel_transposed():
    p = _np(jm.init_dense(jax.random.PRNGKey(1), 3, 5, use_bias=True))
    sd = params_from_jax(p)
    assert sd["weight"].shape == (5, 3)
    np.testing.assert_array_equal(sd["weight"].numpy(), p["kernel"].T)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    p = {"scale": jnp.asarray(rng.standard_normal(16) + 1, jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(16), jnp.float32)}
    x = (rng.standard_normal((2, 9, 16)) * 3 + 5).astype(np.float32)
    ln = load_jax_params(tm.init_layernorm(16), _np(p))
    np.testing.assert_allclose(tm.layernorm(ln, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.layernorm(p, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("dims", [(3, 64, 64, 2), (64, 64, 1, 2), (32, 32, 32, 3), (5, 8, 6, 1)],
                         ids=["in_proj", "out_proj", "kv_proj", "no_residual"])
def test_resmlp_matches_jax(dims):
    """Covers both residual branches and the tanh GELU (jax.nn.gelu's default)."""
    i, h, o, layers = dims
    rng = np.random.default_rng(2)
    p = jm.init_resmlp(jax.random.PRNGKey(2), i, h, o, layers)
    x = rng.standard_normal((2, 11, i)).astype(np.float32)
    mlp = load_jax_params(tm.init_resmlp(i, h, o, layers, generator=_gen()), _np(p))
    np.testing.assert_allclose(tm.resmlp(mlp, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.resmlp(p, jnp.asarray(x))), **TOL)


def test_init_matches_jax_structure_and_scale():
    """Same parameter names and shapes as the JAX tree; fan-in truncated normal."""
    p = _np(jm.init_resmlp(jax.random.PRNGKey(3), 3, 64, 1, 2))
    mlp = tm.init_resmlp(3, 64, 1, 2, generator=_gen())
    want = {k: tuple(v.shape) for k, v in params_from_jax(p).items()}
    assert {k: tuple(v.shape) for k, v in mlp.state_dict().items()} == want
    w = tm.init_dense(256, 512, generator=_gen()).weight.detach()
    std = 1 / np.sqrt(256)
    assert w.abs().max().item() <= 2 * std + 1e-7
    assert abs(w.std().item() - 0.88 * std) < 0.05 * std   # truncation at 2 sigma


def test_init_is_seeded():
    a = tm.init_dense(8, 8, generator=torch.Generator().manual_seed(5)).weight
    b = tm.init_dense(8, 8, generator=torch.Generator().manual_seed(5)).weight
    c = tm.init_dense(8, 8, generator=torch.Generator().manual_seed(6)).weight
    assert torch.equal(a, b) and not torch.equal(a, c)
