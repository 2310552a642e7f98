"""The port's RWKV-6 LM (the ``ssm`` family, ``models/rwkv_lm.py``) against
the JAX package, and its serving contracts.

The smoke ``rwkv6_3b`` is drawn by the JAX package, its zero-initialised
leaves (the ddlerp mixes, ...) given random values so that every term
reaches the logits, and carried into the port with ``interop``. Token
inputs are drawn with numpy from a seed. Tolerances, as tests/test_torch_lm.py:
the logits (forward, prefill with and without ``lengths``, five decode
steps) and the loss at 1e-4 in fp32 compute, and at 2e-2 of max |logit| in
bf16. The engine: the port's against the JAX engine in fp32 (greedy tokens
equal); the paged pool bit-identical to the dense pool (RWKV-6's state has
no token axis: no paged leaf, as in the JAX engine); a bucketed prefill
against an exact-length one (the chunked form against the scan: 1e-5); a
reused slot as clean as a fresh one; the launcher's ``--smoke`` run.

The helpers here serve tests/test_torch_zamba.py too."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import get_model as jget_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import (
    _jax_leaves,
    from_jax_flat,
    load_jax_params,
    to_jax_flat,
    unstack_layers,
)
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine

from test_torch_serve import _drained as drained, _requests as requests, _serve as serve

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # bf16: of max |logit|
DECODE_STEPS = 5
GEOMETRY = dict(capacity=32, slots=2)
PAGED = dict(pool_tokens=96, block_size=8)
_MODELS = {}


def perturb(tree, seed: int):
    """The JAX tree with every all-zero leaf replaced by N(0, 0.1) draws."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype) if not x.any() else x

    return jax.tree.map(fill, tree)


def models(arch: str, dtype: str = "float32"):
    """(JAX model, JAX params, port model, port net) for the smoke ``arch``
    in ``dtype`` compute, on the same weights."""
    key = (arch, dtype)
    if key not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke(arch), compute_dtype=dtype))
        jp = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), seed=1)
        tm = get_model(replace(get_smoke_config(arch), compute_dtype=dtype), device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(jp))
        # the JAX entry points compiled once each (op by op, every call retraces its scans)
        jm = dataclasses.replace(jm, forward=jax.jit(jm.forward), loss=jax.jit(jm.loss),
                                 prefill=jax.jit(jm.prefill, static_argnums=2),
                                 decode_step=jax.jit(jm.decode_step))
        _MODELS[key] = (jm, jax.tree.map(jnp.asarray, jp), tm, net)
    return _MODELS[key]


def tokens(vocab: int, b: int, t: int, seed: int, lengths=None) -> np.ndarray:
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)
    if lengths is not None:
        toks[np.arange(t)[None, :] >= np.asarray(lengths)[:, None]] = 0
    return toks


def held(got: torch.Tensor, want, dtype: str, tol=None) -> None:
    """Within ``tol`` (default ``TOL[dtype]``): absolute in fp32, of max
    |want| in bf16."""
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    tol = TOL[dtype] if tol is None else tol
    tol = tol if dtype == "float32" else tol * np.abs(want).max()
    assert err <= tol, f"max abs err {err:.3g} > {tol:.3g}"


def bf16_close(got: torch.Tensor, want: torch.Tensor, atol: float) -> None:
    """A bf16 leaf computed from fp32 values that agree to ``atol`` may
    round to either neighbour: held within one bf16 ulp (at most 2^-7 of
    its size)."""
    got, want = got.detach().double(), torch.as_tensor(np.asarray(want, np.float64))
    assert bool(((got - want).abs() <= atol + 2.0 ** -7 * want.abs()).all())


def check_forward_loss(arch: str, dtype: str, tol=None) -> None:
    jm, jp, tm, net = models(arch, dtype)
    toks = tokens(tm.cfg.vocab, 2, 16, seed=3)
    labels = tokens(tm.cfg.vocab, 2, 16, seed=4)
    got, aux = tm.forward(net, {"tokens": torch.from_numpy(toks).long()})
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (2, 16, tm.cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    held(got, want, dtype, tol)
    loss = tm.loss(net, {"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(labels).long()})
    jloss = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    held(loss, jloss, dtype, tol)


def check_prefill_decode(arch: str, dtype: str, t: int, lengths, capacity: int = 32,
                         tol=None, decode_tol=None) -> None:
    """Prefill (with ``lengths`` when given), then DECODE_STEPS greedy steps
    on the JAX package's tokens: the logits of every step held (the prefill
    at ``tol``, the decode steps at ``decode_tol``; default ``TOL``)."""
    jm, jp, tm, net = models(arch, dtype)
    toks = tokens(tm.cfg.vocab, 2, t, seed=5, lengths=lengths)
    batch = {"tokens": torch.from_numpy(toks).long()}
    jbatch = {"tokens": jnp.asarray(toks)}
    if lengths is not None:
        batch["lengths"] = torch.tensor(lengths, dtype=torch.int32)
        jbatch["lengths"] = jnp.asarray(lengths, jnp.int32)
    got, caches = tm.prefill(net, batch, capacity)
    want, jcaches = jm.prefill(jp, jbatch, capacity)
    held(got, want, dtype, tol)
    assert caches.pos.tolist() == np.asarray(jcaches.pos).tolist()
    for _ in range(DECODE_STEPS):
        tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
        got, caches = tm.decode_step(net, torch.from_numpy(tok).long(), caches)
        want, jcaches = jm.decode_step(jp, jnp.asarray(tok), jcaches)
        held(got, want, dtype, decode_tol)
    assert caches.pos.tolist() == np.asarray(jcaches.pos).tolist()


def check_round_trip(arch: str) -> None:
    """to_jax_flat gives the JAX tree's own flat leaves (stacked layers,
    [in, out] kernels), and from_jax_flat gives the state dict back."""
    _, jp, _, net = models(arch)
    sd = net.state_dict()
    flat = to_jax_flat(sd)
    want = _jax_leaves(jax.tree.map(np.asarray, jp))
    assert sorted(flat) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(flat[key], arr, err_msg=key)
    back = from_jax_flat(flat)
    assert sorted(back) == sorted(sd)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key
    # a checkpoint written by the JAX package restores in the port
    fresh = models(arch)[2].init(1)
    fresh.load_state_dict(from_jax_flat(want), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), sd.values()))


def check_bucketed_prefill(arch: str, atol: float, decode_atol: float) -> None:
    """A prompt right-padded to a bucket with its true length against the
    same prompt prefilled at exactly its length: the logits and every state
    leaf at ``atol`` (bf16 leaves within one ulp), the next decode step's
    logits at ``decode_atol``."""
    _, _, tm, net = models(arch)
    n, bucket = 11, 16
    toks = tokens(tm.cfg.vocab, 1, bucket, seed=7, lengths=(n,))
    padded = {"tokens": torch.from_numpy(toks).long(), "lengths": torch.tensor([n])}
    exact = {"tokens": torch.from_numpy(toks[:, :n]).long()}
    got, gc = tm.prefill(net, padded, 32)
    want, wc = tm.prefill(net, exact, 32)
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    for a, b in zip(pytree.tree_leaves(gc), pytree.tree_leaves(wc)):
        if a.dtype == torch.bfloat16:   # a KV leaf: the rows past n are padding
            bf16_close(a[:, :, :n], b[:, :, :n].float(), atol)
        else:
            torch.testing.assert_close(a, b, atol=atol, rtol=0)
    tok = want.argmax(-1)[:, None]
    torch.testing.assert_close(tm.decode_step(net, tok, gc)[0], tm.decode_step(net, tok, wc)[0],
                               atol=decode_atol, rtol=0)


def check_slot_reuse(arch: str) -> None:
    """One slot serving requests in turn: each request's tokens equal those
    of a fresh engine serving it alone (retirement leaves no trace)."""
    _, _, tm, net = models(arch)
    reqs = requests(tm.cfg.vocab, n=3, seed=2)
    for kw in ({}, PAGED):
        reused = serve(ServeEngine(tm, net, capacity=32, slots=1, **kw), reqs)
        alone = [serve(ServeEngine(tm, net, capacity=32, slots=1, **kw), [r])[0] for r in reqs]
        assert reused == alone


def run_launcher(arch: str, *extra: str):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4", *extra],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "3 requests / 12 tokens" in out.stdout
    return out.stdout


# --- the model ------------------------------------------------------------------


def test_full_size_config_builds():
    """The full-size model's entry points build (nothing is allocated), with
    no mixer plan and no prefix-cache path, as in the JAX package."""
    m = get_model(get_config("rwkv6_3b"))
    assert m.plans == {} and m.prefill_suffix is None and m.prefill_into is not None
    assert m.cfg.ssm.kind == "rwkv6" and m.cfg.attn.kind == "none"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    check_forward_loss("rwkv6_3b", dtype)


@pytest.mark.parametrize("t,lengths", [(16, None), (16, (16, 11)), (12, (12, 5))],
                         ids=["chunked", "chunked-lengths", "scan-lengths"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_jax(dtype, t, lengths):
    check_prefill_decode("rwkv6_3b", dtype, t, lengths)


def test_prefill_states_match_jax():
    """Every layer's (tm_last, cm_last, wkv) after a ragged prefill."""
    jm, jp, tm, net = models("rwkv6_3b")
    toks = tokens(tm.cfg.vocab, 2, 16, seed=6, lengths=(16, 9))
    _, caches = tm.prefill(net, {"tokens": torch.from_numpy(toks).long(),
                                 "lengths": torch.tensor([16, 9])}, 32)
    _, jcaches = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray([16, 9], jnp.int32)}, 32)
    for i, st in enumerate(caches.states):
        for name, leaf in st._asdict().items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(getattr(jcaches.states, name)[i]),
                                       atol=1e-4, rtol=0, err_msg=f"layer {i} {name}")


def test_interop_round_trip():
    check_round_trip("rwkv6_3b")


# --- serving ----------------------------------------------------------------------


def test_engine_matches_jax_engine():
    """The dense pool in fp32 compute: the JAX engine's greedy tokens."""
    jm, jp, tm, net = models("rwkv6_3b")
    reqs = requests(tm.cfg.vocab)
    jeng = JServeEngine(jm, jp, **GEOMETRY)
    for prompt, max_new in reqs:
        jeng.submit(prompt, max_new_tokens=max_new)
    want = [o.tolist() for o in jeng.run_all()]
    assert serve(ServeEngine(tm, net, **GEOMETRY), reqs) == want


def test_paged_pool_bit_identical_to_dense():
    """The state has no token axis: the paged pool pages nothing, keeps the
    whole state dense (no kernel route), and serves the dense pool's tokens."""
    _, _, tm, net = models("rwkv6_3b")
    reqs = requests(tm.cfg.vocab)
    dense = ServeEngine(tm, net, **GEOMETRY)
    paged = ServeEngine(tm, net, **GEOMETRY, **PAGED)
    assert not paged._has_paged and paged.slot_cache.spec.paged == ()
    assert paged.stats["decode_backend"] == "dense"
    assert serve(paged, reqs) == serve(dense, reqs)
    drained(paged)
    with pytest.raises(ValueError, match="not eligible"):
        ServeEngine(tm, net, **GEOMETRY, **PAGED, decode_backend="paged")


def test_bucketed_prefill_matches_exact_length():
    check_bucketed_prefill("rwkv6_3b", atol=1e-5, decode_atol=1e-5)


def test_slot_reuse_is_clean():
    check_slot_reuse("rwkv6_3b")


def test_launcher_smoke():
    out = run_launcher("rwkv6_3b", "--warmup", "--max-decode-compiles", "0")
    assert "decode backend: dense" in out and "0 while serving" in out
