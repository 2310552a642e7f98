"""The port's spectral analysis (``repro_torch/core/spectral.py``, Algorithm
1 of App. C) against the JAX package's ``repro/core/spectral.py`` on the CPU,
on the same numpy inputs, at the tolerances of ``tests/test_spectral.py``
(1e-5): the eigenvalues, the effective rank, the per-head spectra, and the
eigenvectors up to sign (each column's largest entry made positive)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spectral as jspec
from repro_torch import core as tcore
from repro_torch.core import spectral as tspec

TOL = 1e-5


def _inputs(m, n, d, *, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return ((scale * rng.standard_normal((m, d))).astype(np.float32),
            (scale * rng.standard_normal((n, d))).astype(np.float32))


def _signed(vecs: np.ndarray) -> np.ndarray:
    """Each column with the sign that makes its largest-magnitude entry positive."""
    idx = np.abs(vecs).argmax(axis=0)
    return vecs * np.sign(vecs[idx, np.arange(vecs.shape[1])])


@pytest.mark.parametrize("m,n,d", [(8, 50, 16), (16, 200, 8), (12, 10, 8)])
def test_flare_spectrum_matches_jax(m, n, d):
    """Eigenvalues (descending) within 1e-5; where M > N the tail is ~0 in
    both. The eigenvectors of the well-separated leading eigenvalues agree
    up to sign within 1e-5."""
    q, k = _inputs(m, n, d)
    jv, jvec = (np.asarray(x) for x in jspec.flare_spectrum(jnp.asarray(q), jnp.asarray(k)))
    tv, tvec = (x.numpy() for x in tspec.flare_spectrum(torch.from_numpy(q),
                                                         torch.from_numpy(k)))
    np.testing.assert_allclose(tv, jv, atol=TOL)
    assert (np.diff(tv) <= 1e-6).all()
    r = min(m, n)
    gaps = np.abs(np.diff(jv[:r]))
    lead = [i for i in range(r - 1) if min(gaps[i], gaps[i - 1] if i else np.inf) > 1e-2
            and jv[i] > 1e-2]
    assert lead, jv
    np.testing.assert_allclose(_signed(tvec[:, lead]), _signed(jvec[:, lead]), atol=TOL)


def test_flare_spectrum_without_vectors():
    q, k = _inputs(6, 40, 8, seed=1)
    vals, vecs = tspec.flare_spectrum(torch.from_numpy(q), torch.from_numpy(k),
                                      return_vectors=False)
    jvals, _ = jspec.flare_spectrum(jnp.asarray(q), jnp.asarray(k), return_vectors=False)
    assert vecs is None
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=TOL)


def test_dense_oracle_matches_jax_and_algorithm_1():
    """The O(N^3) oracle: eigenvalues and W against the JAX oracle's, its top
    M against Algorithm 1, the rest ~0 (rank <= M); W v = lambda v for
    Algorithm 1's eigenvectors."""
    q, k = _inputs(8, 50, 16, seed=2)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    dense, w = tspec.flare_spectrum_dense(tq, tk)
    jdense, jw = (np.asarray(x) for x in jspec.flare_spectrum_dense(jnp.asarray(q),
                                                                    jnp.asarray(k)))
    np.testing.assert_allclose(dense.numpy(), jdense, atol=TOL)
    np.testing.assert_allclose(w.numpy(), jw, atol=TOL)
    vals, vecs = tspec.flare_spectrum(tq, tk)
    np.testing.assert_allclose(vals.numpy(), dense[:8].numpy(), atol=TOL)
    np.testing.assert_allclose(dense[8:].numpy(), 0.0, atol=TOL)
    assert (w @ vecs - vecs * vals[None, :]).abs().max() < 1e-4


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.99])
def test_effective_rank_matches_jax(threshold):
    rng = np.random.default_rng(3)
    for vals in (np.array([10.0, 1.0, 0.01, 0.0001, 0.0], np.float32),
                 np.sort(rng.exponential(size=16).astype(np.float32))[::-1].copy(),
                 np.array([1.0, -1e-7, 0.0], np.float32)):
        want = int(jspec.effective_rank(jnp.asarray(vals), threshold=threshold))
        assert int(tspec.effective_rank(torch.from_numpy(vals), threshold=threshold)) == want


def test_spectrum_by_head_matches_jax():
    rng = np.random.default_rng(4)
    q = (0.5 * rng.standard_normal((3, 8, 8))).astype(np.float32)
    k = (0.5 * rng.standard_normal((3, 64, 8))).astype(np.float32)
    got = tspec.spectrum_by_head(torch.from_numpy(q), torch.from_numpy(k))
    want = np.asarray(jspec.spectrum_by_head(jnp.asarray(q), jnp.asarray(k)))
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_large_scores_stay_finite_and_fp64_agrees():
    """Scores of ~100 (columns whose mass underflows in fp32): the log-space
    J keeps every eigenvalue finite and in [0, 1 + 1e-5], as in JAX; the fp64
    spectrum agrees within 1e-5."""
    q, k = _inputs(8, 60, 8, seed=5, scale=3.0)
    tv, _ = tspec.flare_spectrum(torch.from_numpy(q), torch.from_numpy(k))
    jv, _ = jspec.flare_spectrum(jnp.asarray(q), jnp.asarray(k))
    wide, _ = tspec.flare_spectrum(torch.from_numpy(q).double(), torch.from_numpy(k).double())
    assert torch.isfinite(tv).all() and tv.max() <= 1 + TOL and tv.min() >= -TOL
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(tv.double().numpy(), wide.numpy(), atol=TOL)


def test_core_exports_the_spectrum_as_the_reference_does():
    from repro import core as jcore

    assert tcore.flare_spectrum is tspec.flare_spectrum
    assert tcore.flare_spectrum_dense is tspec.flare_spectrum_dense
    assert {"flare_spectrum", "flare_spectrum_dense"} <= set(jcore.__all__)
    assert {"flare_spectrum", "flare_spectrum_dense"} <= set(tcore.__all__)
