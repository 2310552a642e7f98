"""Small pieces of the JAX package the port lacked, held against their JAX
counterparts on the CPU on the same numpy inputs (fp32, 1e-5 where the
arithmetic is in another order, exact where it is the same):
``optim/adamw.py::clip_by_global_norm``, ``obs/metrics.py::get_registry``,
``core/flare_stream.py::stream_insert_slots`` / ``stream_reset_slots``,
``core/flare.py::sdpa(mask=)``, and ``core/dispatch.py``'s ``backends``,
``device_kind``, ``describe``, ``run_mixer``, ``run_causal_mixer`` and the
``--list`` CLI (its rows and exit code)."""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core.flare import sdpa as jsdpa
from repro.core.flare_stream import FlareState as JState
from repro.core.flare_stream import stream_insert_slots as jinsert
from repro.core.flare_stream import stream_reset_slots as jreset
from repro.obs import metrics as jmetrics
from repro.optim.adamw import clip_by_global_norm as jclip
from repro_torch.core import dispatch
from repro_torch.core.flare import sdpa
from repro_torch.core.flare_stream import FlareState, stream_init, stream_insert_slots, \
    stream_reset_slots
from repro_torch.obs import metrics
from repro_torch.optim.adamw import adamw_update, clip_by_global_norm, init_adamw

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _grads(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in (("a", (4, 3)), ("b", (7,)), ("c", (2, 2, 5)))}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipping active (max_norm below the norm) and not: the scaled
    gradients and the norm before clipping."""
    g = _grads()
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    want, jnorm = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    assert abs(float(norm) - float(jnorm)) <= TOL * float(jnorm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL)
    total = float(torch.linalg.vector_norm(torch.cat([t.flatten() for t in got.values()])))
    assert total <= max_norm * (1 + TOL) and got["a"].dtype == torch.float32


def test_adamw_update_clips_as_clip_by_global_norm_bit_for_bit():
    """The update with grad_clip gives the same parameter bits as the update
    without it on clip_by_global_norm's gradients, and the same norm."""
    g = {k: torch.from_numpy(v) for k, v in _grads(1, scale=3.0).items()}
    p0 = {k: torch.from_numpy(v) for k, v in _grads(2).items()}
    pa, pb = ({k: v.clone() for k, v in p0.items()} for _ in range(2))
    _, _, na = adamw_update(pa, g, init_adamw(pa), lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    clipped, nc = clip_by_global_norm(g, 1.0)
    _, _, nb = adamw_update(pb, clipped, init_adamw(pb), lr=1e-2, weight_decay=1e-4)
    assert float(na) == float(nc) and float(nb) < float(na)
    for k in p0:
        assert torch.equal(pa[k], pb[k]), k
        assert not torch.equal(pa[k], p0[k])


def test_get_registry_is_the_process_wide_default():
    reg = metrics.get_registry()
    assert reg is metrics.get_registry() is metrics.REGISTRY
    assert isinstance(reg, metrics.MetricsRegistry) and reg.enabled
    assert metrics.NULL_REGISTRY is not reg and not metrics.NULL_REGISTRY.enabled
    jreg = jmetrics.get_registry()
    assert jreg is jmetrics.get_registry() and jreg.enabled
    c = reg.counter("parity.gaps.test")
    c.inc(2)
    assert reg.snapshot()["parity.gaps.test"] == 2


def _pool(seed, b=5, h=2, m=3, d=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, m)).astype(np.float32),
            rng.standard_normal((b, h, m, d)).astype(np.float32),
            rng.random((b, h, m)).astype(np.float32))


def test_stream_insert_and_reset_slots_match_jax():
    """Insert two prefilled lanes at slots 3 and 1, then reset slots 1 and 4:
    every field equal to JAX's; the reset slots' m_max is -inf (not 0), num
    and den 0; the pool passed in is not modified."""
    pool, part = _pool(0), _pool(1, b=2)
    slots = np.array([3, 1], np.int32)
    tpool = FlareState(*(torch.from_numpy(x) for x in pool))
    before = [t.clone() for t in tpool]
    got = stream_insert_slots(tpool, FlareState(*(torch.from_numpy(x) for x in part)),
                              torch.from_numpy(slots))
    want = jinsert(JState(*(jnp.asarray(x) for x in pool)), JState(*(jnp.asarray(x) for x in part)),
                   jnp.asarray(slots))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in zip(tpool, before))
    reset = np.array([1, 4], np.int32)
    got = stream_reset_slots(got, torch.from_numpy(reset))
    want = jreset(want, jnp.asarray(reset))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.isneginf(got.m_max[reset]).all() and not got.num[reset].any()
    assert not got.den[reset].any() and torch.equal(got.m_max[3], torch.from_numpy(part[0][0]))
    fresh = stream_init(2, 2, 3, 4)
    assert torch.equal(stream_reset_slots(FlareState(*fresh), torch.tensor([0, 1])).m_max,
                       fresh.m_max)


def test_sdpa_mask_matches_jax():
    """A boolean mask broadcast over heads: the kept scores' softmax at 1e-5
    of JAX's; a row with no key kept is NaN in both (jax.nn.softmax's all
    -inf row); without a mask the same as before."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 6, 4)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, 1, 5, 6)) > 0.4
    mask[:, :, :, 0] = True
    mask[1, 0, 2] = False   # no key for this row
    got = sdpa(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.5, mask=torch.from_numpy(mask))
    want = np.asarray(jsdpa(*(jnp.asarray(x) for x in (q, k, v)), scale=0.5,
                            mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[1, :, 2]).all() and np.isnan(want).sum() == 3 * 4
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, equal_nan=True)
    plain = sdpa(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jsdpa(*(jnp.asarray(x) for x in
                                                               (q, k, v)), scale=0.5)), atol=TOL)


JAX_ONLY = {"paged_shard"}   # the JAX package's slot-sharded serving route


@pytest.mark.parametrize("causal,sharded", [(None, None), (True, None), (False, None),
                                            (None, True), (None, False), (False, True)])
def test_backends_match_jax(causal, sharded):
    names = [b.name for b in dispatch.backends(causal=causal, sharded=sharded)]
    want = [b.name for b in jdispatch.backends(causal=causal, sharded=sharded)]
    assert names == [n for n in want if n not in JAX_ONLY] and names == sorted(names)


def test_device_kind_and_describe_match_jax():
    """device_kind on this CPU; the plain backends' plans as JAX describes
    them; the FLARE kernel backends with their own launch parameters (the
    kernels' defaults here: 256 rows a block, one split of 64 tokens), the
    causal kernel by name (its tile is fixed in the port)."""
    assert dispatch.device_kind() == jdispatch.device_kind() == "cpu"
    kw = dict(batch=2, heads=4, tokens=64, latents=8, head_dim=8)
    shape, jshape = dispatch.MixerShape(**kw), jdispatch.MixerShape(**kw)
    for impl, causal in (("auto", False), ("sdpa", False), ("materialized", False),
                         ("paged", False), ("auto", True), ("causal_stream", True)):
        assert dispatch.describe(impl, shape=shape, causal=causal) == \
            jdispatch.describe(impl, shape=jshape, causal=causal), impl
    for impl, causal, want in (("pallas", False, "pallas(block_m=256;block_n=64)"),
                               ("packed", False, "packed(block_n=64;block_m=256)"),
                               ("causal_pallas", True, "causal_pallas")):
        assert dispatch.describe(impl, shape=shape, causal=causal) == want
        assert jdispatch.describe(impl, shape=jshape, causal=causal).startswith(impl + "(")


def _qkv(seed, b=2, h=2, m=8, n=40, d=8):
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.standard_normal((h, m, d))).astype(np.float32),
            *(rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2)))


@pytest.mark.parametrize("impl", ["auto", "sdpa", "materialized", "packed", "pallas"])
def test_run_mixer_matches_jax(impl):
    q, k, v = _qkv(11)
    got = dispatch.run_mixer(impl, *(torch.from_numpy(x) for x in (q, k, v)))
    want = jdispatch.run_mixer("sdpa", *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("impl,chunk", [("auto", None), ("causal_stream", 8),
                                        ("causal_pallas", None)])
def test_run_causal_mixer_matches_jax(impl, chunk):
    q, k, v = _qkv(12)
    got = dispatch.run_causal_mixer(impl, *(torch.from_numpy(x) for x in (q, k, v)),
                                    chunk_size=chunk)
    want = jdispatch.run_causal_mixer("causal_stream", *(jnp.asarray(x) for x in (q, k, v)),
                                      chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    with pytest.raises(ValueError, match="not causal"):
        dispatch.run_causal_mixer("sdpa", *(torch.from_numpy(x) for x in (q, k, v)))


def _rows(text: str) -> dict:
    """{backend: its columns} of the --list table."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("---")) + 1
    return {line.split()[0]: line.split("#")[0].split()[1:] for line in lines[start:]
            if line.strip() and not line.startswith("ERROR")}


def _run_main(main, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_list_cli_rows_and_exit_code_match_jax():
    """In process: exit 0 and, for every backend both packages register, the
    same columns (grads, now, with-mesh and the four canonical policies)."""
    rc, text = _run_main(dispatch.main, ["--list"])
    jrc, jtext = _run_main(jdispatch.main, ["--list"])
    rows, jrows = _rows(text), _rows(jtext)
    assert rc == jrc == 0
    assert set(rows) == set(jrows) - JAX_ONLY
    for name, cols in rows.items():
        assert cols == jrows[name], name
    assert text.splitlines()[0] == "device=cpu  probe shape: N=1024 M=16 D=8 H=4"


def test_list_cli_fails_without_a_causal_backend_or_on_mesh_symmetry(monkeypatch):
    """Exit 1 where a canonical policy has no eligible backend (the causal
    backends taken out), and where a backend is eligible both with and
    without a mesh."""
    dispatch._ensure_loaded()
    full = dict(dispatch._REGISTRY)
    monkeypatch.setattr(dispatch, "_REGISTRY",
                        {k: b for k, b in full.items() if not b.caps.causal})
    rc, text = _run_main(dispatch.main, [])
    assert rc == 1 and "ERROR: no eligible backend for policy causal/infer" in text
    monkeypatch.setattr(dispatch, "_REGISTRY", full)
    real = dispatch.eligible
    monkeypatch.setattr(dispatch, "eligible", lambda b, **kw: (
        b.name == "sdpa" or real(b, **kw)))
    rc, text = _run_main(dispatch.main, [])
    assert rc == 1 and "ERROR: backend sdpa eligible both with and without a mesh" in text


def test_list_cli_as_a_module():
    """``python -m repro_torch.core.dispatch --list`` delegates to the module
    the backends registered with: every backend listed, exit 0."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.dispatch", "--list"],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert set(_rows(out.stdout)) == {b.name for b in dispatch.backends()}
