"""The kernels' plain versions against the JAX package's kernels.

On CPU tensors every wrapper in ``repro_torch.kernels`` runs its plain
version, which is what these tests hold against the Pallas kernels, run in
interpret mode as the JAX tests run them. Tolerances: fp32 atol 1e-5
(tests/test_kernels.py), bf16 2e-2. The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flare import flare_decode_pallas, flare_encode_pallas
from repro.kernels.flare_packed import flare_mixer_packed
from repro_torch.core.dispatch import MixerPlan
from repro_torch.core.policy import run_plan
from repro_torch.kernels import ref
from repro_torch.kernels.flare import flare_decode, flare_encode
from repro_torch.kernels.flare_packed import flare_fused_fwd
from repro_torch.kernels.ops import flare_mixer_fused, launch_counts

# (B, H, M, N, D): ragged N and M=16, the paper's width at a short N
SHAPES = [(2, 4, 16, 97, 8), (1, 8, 2048, 300, 8), (2, 3, 24, 64, 4)]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(b, h, m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((h, m, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k, v


def _t(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype):
    return jnp.asarray(x, dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("grouped_q", [True, False], ids=["q_per_head", "q_per_group"])
def test_encode_matches_pallas(shape, dtype, grouped_q):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    kg, vg = k.reshape(b * h, n, d), v.reshape(b * h, n, d)
    qg = q if grouped_q else np.tile(q, (b, 1, 1))        # Gq = H or Gq = G
    want = flare_encode_pallas(_j(qg, jdt), _j(kg, jdt), _j(vg, jdt), block_n=n,
                               block_m=min(128, m), interpret=True)
    # the port takes the per-head layout: q [H, M, D], k/v [B, H, N, D]
    got = flare_encode(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.shape == (b, h, m, d) and got.dtype == tdt
    _close(got.reshape(b * h, m, d), want, atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_matches_pallas(shape, dtype):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    kg = k.reshape(b * h, n, d)
    z = np.random.default_rng(1).standard_normal((b * h, m, d)).astype(np.float32)
    want = flare_decode_pallas(_j(q, jdt), _j(kg, jdt), _j(z, jdt), block_n=n, interpret=True)
    got = flare_decode(_t(q, tdt), _t(k, tdt), _t(z.reshape(b, h, m, d), tdt))
    assert got.shape == (b, h, n, d) and got.dtype == tdt
    _close(got.reshape(b * h, n, d), want, atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_strided_views_match_contiguous(shape):
    """[B, H, N, D] views of [B, N, H, D] storage (the model's split heads)
    give what contiguous operands give, for every wrapper."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(*shape))
    kv = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)   # [B,N,H,D] storage
    z = flare_encode(q, k, v)
    torch.testing.assert_close(flare_encode(q, kv(k), kv(v)), z, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(flare_decode(q, kv(k), z), flare_decode(q, k, z),
                               atol=1e-6, rtol=1e-6)
    for got, want in zip(flare_fused_fwd(q, kv(k), kv(v)), flare_fused_fwd(q, k, v)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_fwd_matches_packed_and_definitions(shape, dtype):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    y, z, mx, den = flare_fused_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert y.dtype == tdt and z.dtype == mx.dtype == den.dtype == torch.float32
    _close(y, flare_mixer_packed(_j(q, jdt), _j(k, jdt), _j(v, jdt)), atol)
    # the residuals, by their definitions through the JAX reference
    qj = _j(q, jdt).astype(jnp.float32)
    kj, vj = (_j(x, jdt).astype(jnp.float32).reshape(b * h, n, d) for x in (k, v))
    qg = jnp.tile(qj, (b, 1, 1))
    _close(z.reshape(b * h, m, d), jref.flare_encode_ref(qg, kj, vj), 1e-5)
    s = jnp.einsum("gmd,gnd->gmn", qg, kj)
    smax = jnp.max(s, axis=-1)
    _close(mx.reshape(b * h, m), smax, 1e-5)
    _close(den.reshape(b * h, m), jnp.sum(jnp.exp(s - smax[..., None]), axis=-1), 1e-5)


def test_plain_mixer_matches_jax_reference():
    q, k, v = _inputs(2, 4, 16, 97, 8)
    want = jref.flare_mixer_ref(*(jnp.asarray(x) for x in (np.tile(q, (2, 1, 1)),
                                                           k.reshape(8, 97, 8), v.reshape(8, 97, 8))))
    got = ref.flare_mixer_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got.reshape(8, 97, 8), want, 1e-5)


@pytest.mark.parametrize("backend", ["pallas", "packed"])
def test_kernel_backends_take_plain_path_on_cpu(backend):
    """On CPU tensors the kernel backends run the plain versions: same result,
    no launch counted."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 16, 97, 8))
    before = launch_counts()
    y = run_plan(MixerPlan(backend), q, k, v)
    torch.testing.assert_close(y, ref.flare_mixer_ref(q, k, v), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(flare_mixer_fused(q, k, v), y, atol=1e-5, rtol=1e-5)
    assert launch_counts() == before


@pytest.mark.parametrize("call", ["encode", "decode", "fused", "packed_backend"])
def test_grad_requiring_call_raises(call):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 33, 8))
    q.requires_grad_(True)
    fns = {"encode": lambda: flare_encode(q, k, v),
           "decode": lambda: flare_decode(q, k, torch.zeros(1, 2, 16, 8)),
           "fused": lambda: flare_fused_fwd(q, k, v),
           "packed_backend": lambda: run_plan(MixerPlan("packed"), q, k, v)}
    with pytest.raises(RuntimeError, match="forward-only"):
        fns[call]()
    with torch.no_grad():
        fns[call]()   # inference is fine


def test_wrappers_reject_bad_operands():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 33, 8))
    with pytest.raises(ValueError, match="expected"):
        flare_encode(q, k[:, :1], v[:, :1])                    # head count differs
    with pytest.raises(ValueError, match="dtype"):
        flare_fused_fwd(q, k, v.double())
    with pytest.raises(ValueError, match="expected"):
        flare_encode(q, k.reshape(2, 33, 8), v.reshape(2, 33, 8))   # the Pallas [G, N, D]
    with pytest.raises(ValueError, match="z must be"):
        flare_decode(q, k, torch.zeros(2, 16, 8))
    with pytest.raises(ValueError, match="no kernel for device"):
        flare_fused_fwd(*(x.to("meta") for x in (q, k, v)))
    with pytest.raises(ValueError, match="empty"):
        flare_fused_fwd(q, k[:, :, :0], v[:, :, :0])
