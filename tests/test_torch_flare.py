"""The port's FLARE operator, layer, block and policy against the JAX package.

Mixer outputs are held at atol 1e-5 (fp32, tests/test_flare_core.py). Policy
resolution for ``device="cuda"`` is a capability lookup and needs no card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flare as jflare
from repro.core.policy import MixerPolicy as JPolicy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import flare as tflare
from repro_torch.core.dispatch import MixerShape, eligible, get_backend, resolve
from repro_torch.core.policy import MixerPolicy, current_policy, mixer_policy, resolve_policy
from repro_torch.interop import load_jax_params
from repro_torch.models.api import get_model

BACKENDS = ["sdpa", "materialized", "pallas", "packed"]
SHAPE = MixerShape(batch=1, heads=8, tokens=4096, latents=2048, head_dim=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qkv(b=2, h=4, m=16, n=97, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((h, m, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, h, n, d)) * 0.5).astype(np.float32),
            rng.standard_normal((b, h, n, d)).astype(np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixer_backend_matches_jax_sdpa(backend):
    q, k, v = _qkv()
    want = jflare.flare_mixer(*map(jnp.asarray, (q, k, v)), policy=JPolicy(backends=("sdpa",)))
    got = tflare.flare_mixer(*map(torch.from_numpy, (q, k, v)),
                             policy=MixerPolicy(backends=(backend,)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dense_operator_matches_jax():
    q, k, _ = _qkv(b=1, n=23)
    want = jflare.flare_dense_operator(jnp.asarray(q), jnp.asarray(k[0]))
    got = tflare.flare_dense_operator(torch.from_numpy(q), torch.from_numpy(k[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("backend", ["sdpa", "packed"])
def test_flare_layer_and_block_match_jax(backend):
    dim, heads, latents = 32, 4, 16
    x = np.random.default_rng(3).standard_normal((2, 37, dim)).astype(np.float32)
    jp = jflare.init_flare_block(jax.random.PRNGKey(0), dim, heads, latents)
    block = tflare.init_flare_block(dim, heads, latents, generator=torch.Generator().manual_seed(0))
    load_jax_params(block, _np(jp))
    pol = MixerPolicy(backends=(backend,))
    with torch.no_grad():
        got_layer = tflare.flare_layer(block.mixer, torch.from_numpy(x), policy=pol)
        got_block = tflare.flare_block(block, torch.from_numpy(x), policy=pol)
    jpol = JPolicy(backends=("sdpa",))
    np.testing.assert_allclose(got_layer.numpy(),
                               np.asarray(jflare.flare_layer(jp["mixer"], jnp.asarray(x), policy=jpol)),
                               atol=1e-5)
    np.testing.assert_allclose(got_block.numpy(),
                               np.asarray(jflare.flare_block(jp, jnp.asarray(x), policy=jpol)),
                               atol=1e-5)


def test_merge_heads_of_kernel_layout_is_a_view():
    """The layout the kernels write y in makes merging heads free."""
    y = torch.empty(2, 7, 4, 8).permute(0, 2, 1, 3)      # [B, H, N, D] over [B, N, H, D]
    assert tflare._merge_heads(y).data_ptr() == y.data_ptr()
    assert tflare._merge_heads(y)._base is not None


# --- properties (tests/test_flare_core.py) ---------------------------------


def test_dense_operator_rows_sum_to_one():
    q, k, _ = _qkv(b=1, n=40)
    w = tflare.flare_dense_operator(torch.from_numpy(q), torch.from_numpy(k[0]))
    torch.testing.assert_close(w.sum(-1), torch.ones(4, 40), atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,n", [(8, 40), (16, 12)])
def test_dense_operator_rank_at_most_m(m, n):
    q, k, _ = _qkv(b=1, m=m, n=n)
    w = tflare.flare_dense_operator(torch.from_numpy(q), torch.from_numpy(k[0])).double()
    for h in range(w.shape[0]):
        assert torch.linalg.matrix_rank(w[h], atol=1e-5).item() <= min(m, n)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixer_permutation_equivariant(backend):
    q, k, v = map(torch.from_numpy, _qkv(n=23))
    perm = torch.from_numpy(np.random.default_rng(1).permutation(23))
    pol = MixerPolicy(backends=(backend,))
    y = tflare.flare_mixer(q, k, v, policy=pol)
    y_perm = tflare.flare_mixer(q, k[:, :, perm], v[:, :, perm], policy=pol)
    torch.testing.assert_close(y[:, :, perm], y_perm, atol=1e-5, rtol=1e-5)


# --- policy: requires_grad never resolves a forward-only kernel ------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["pallas"])
def test_grad_never_resolves_kernel_backends(device, name):
    """The two-launch kernels are forward-only, as the JAX pallas backend is."""
    backend = get_backend(name)
    assert not eligible(backend, dtype=torch.float32, device=device, grad=True)
    assert eligible(backend, dtype=torch.float32, device=device)
    with pytest.raises(ValueError, match="forward-only"):
        resolve(name, shape=SHAPE, dtype=torch.float32, device=device, grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        resolve_policy(MixerPolicy(backends=(name,), requires_grad=True), SHAPE, device=device)
    plan = resolve_policy(MixerPolicy(backends=(name, "sdpa"), requires_grad=True), SHAPE,
                          device=device)
    assert plan.backend == "sdpa"
    auto = resolve_policy(MixerPolicy(requires_grad=True), SHAPE, device=device).backend
    assert auto == ("packed" if device == "cuda" else "sdpa")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_grad_resolves_packed(device):
    """The fused backend has its backward kernel: a differentiated plan may
    name it, and "auto" picks it on the card (on the CPU the plain sdpa
    outscores its plain versions)."""
    backend = get_backend("packed")
    assert eligible(backend, dtype=torch.float32, device=device, grad=True)
    assert resolve("packed", shape=SHAPE, dtype=torch.float32, device=device,
                   grad=True)[1].backend == "packed"
    plan = resolve_policy(MixerPolicy(backends=("pallas", "packed", "sdpa"), requires_grad=True),
                          SHAPE, device=device)
    assert plan.backend == "packed"
    auto = resolve_policy(MixerPolicy(requires_grad=True), SHAPE, device=device).backend
    assert auto == ("packed" if device == "cuda" else "sdpa")


# the fused kernels' default launch parameters at SHAPE on an H100 (132 SMs,
# also what the defaults assume without a card): 256 latent rows a block,
# 4 splits of 1,024 tokens (backends/autotune.py)
PACKED_AT_SHAPE = "packed(block_n=1024;block_m=256)"


def test_auto_picks_fused_kernel_on_cuda_and_sdpa_on_cpu():
    assert resolve_policy(None, SHAPE, device="cuda").describe() == PACKED_AT_SHAPE
    assert resolve_policy(None, SHAPE, device="cpu").backend == "sdpa"


def test_model_plans_on_cuda_need_no_card():
    m = get_model(get_config("flare_pde"), device="cuda")
    assert m.plans["infer"].describe() == PACKED_AT_SHAPE
    assert m.plans["train"].describe() == PACKED_AT_SHAPE
    assert get_model(get_config("flare_pde"), device="cpu").plans["train"].describe() == "sdpa"


def test_inference_only_policy_builds_and_refuses_to_train():
    m = get_model(get_smoke_config("flare_pde"), device="cpu",
                  policy=MixerPolicy(backends=("pallas",)))
    assert "train" not in m.plans
    net = m.init(0)
    x = torch.randn(1, 9, 3)
    assert m.forward(net, {"x": x}).shape == (1, 9, 1)
    with pytest.raises(ValueError, match="inference-only"):
        m.loss(net, {"x": x, "y": torch.randn(1, 9, 1)})


def test_policy_stack_nests_and_restores():
    assert current_policy() == MixerPolicy()
    with mixer_policy(requires_grad=True):
        assert current_policy().requires_grad
        with mixer_policy(MixerPolicy(backends="materialized")):
            assert current_policy().backends == ("materialized",)
            assert resolve_policy(None, SHAPE, device="cpu").backend == "materialized"
        assert current_policy().backends == ("auto",)
        with pytest.raises(RuntimeError):
            with mixer_policy(backends=("sdpa",)):
                raise RuntimeError
        assert current_policy() == MixerPolicy(requires_grad=True)
    assert current_policy() == MixerPolicy()


def test_unknown_backend_and_device_errors():
    with pytest.raises(ValueError, match="unknown mixer backend"):
        resolve("nope", shape=SHAPE, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no eligible"):
        resolve("auto", shape=SHAPE, dtype=torch.float32, device="mps")
