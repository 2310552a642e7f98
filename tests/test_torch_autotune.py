"""The port's launch-parameter autotuner (``repro_torch.backends.autotune``)
against the reference's tests (tests/test_backends.py, test_policy.py,
test_packed.py, test_mesh_parallel.py), its keys against the JAX package's,
its defaults against the kernels' own rules, and the plans that carry its
parameters against the JAX mixer. CPU only: no runner is offered without a
card, so nothing here times a kernel."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import autotune as jautotune
from repro.core import dispatch as jdispatch
from repro.core import flare as jflare
from repro.core.policy import MixerPolicy as JPolicy
from repro_torch.backends import autotune
from repro_torch.core.dispatch import MixerPlan, MixerShape, resolve
from repro_torch.core.policy import MixerPolicy, resolve_policy, run_plan
from repro_torch.kernels import flare as kflare

F32 = torch.float32
SHAPE = MixerShape(batch=1, heads=2, tokens=300, latents=16, head_dim=8)


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Every test on its own cache file, autotuning off unless it opts in."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune._MEM_CACHE.clear()
    yield path
    autotune._MEM_CACHE.clear()


def _fake_runner(winner: dict):
    """A runner that pretends ``winner`` is fastest."""
    calls = []

    def runner(params):
        calls.append(params)
        return 0.001 if all(params[k] == v for k, v in winner.items()) else 0.002

    return runner, calls


# --- the reference's cases ---------------------------------------------------


@pytest.mark.parametrize("kind,backend", [("tiles", "pallas"), ("packed", "packed")])
def test_cache_roundtrip_feeds_the_plan(cache, kind, backend):
    """test_backends.py::test_cache_roundtrip, test_packed.py::
    test_packed_kind_cache_roundtrip: the winner is stored, read back after a
    cold start, and the backend's plan carries it; the kinds do not collide."""
    shape = MixerShape(1, 2, 3000, 16, 8)
    runner, calls = _fake_runner({"block_m": 128, "block_n": 1500})
    best = autotune.measure_tiles(shape, F32, "cpu", runner, kind=kind)
    assert (best["block_m"], best["block_n"]) == (128, 1500) and len(calls) > 1
    entry = json.loads(cache.read_text())[autotune.cache_key(shape, F32, "cpu", kind)]
    assert entry["candidates"] == len(calls) == len(entry["timed"])
    autotune._MEM_CACHE.clear()
    got = autotune.best_params(shape, F32, "cpu", kind=kind)
    assert got == {"block_m": 128, "block_n": 1500}
    assert list(got) == list(autotune._KIND_PARAMS[kind])
    plan = resolve(backend, shape=shape, dtype=F32, device="cpu")[1]
    assert (plan.params["block_m"], plan.params["block_n"]) == (128, 1500)
    assert plan.describe() in (f"{backend}(block_m=128;block_n=1500)",
                               f"{backend}(block_n=1500;block_m=128)")
    other = "packed" if kind == "tiles" else "tiles"
    assert autotune.best_params(shape, F32, "cpu", kind=other) == \
        autotune._DEFAULTS[other](shape)


@pytest.mark.parametrize("kind", ["tiles", "packed"])
def test_heuristic_without_cache(kind):
    """test_backends.py::test_heuristic_without_cache: no cache, no timing,
    the defaults, which the kernels take."""
    shape = MixerShape(1, 2, 37, 8, 16)
    got = autotune.best_params(shape, F32, "cpu", kind=kind)
    assert got == autotune._DEFAULTS[kind](shape) == {"block_m": 128, "block_n": 37}
    kflare.check_tiles("test", shape.head_dim, shape.tokens, got["block_m"], got["block_n"])


def test_cache_key_carries_runtime_version():
    key = autotune.cache_key(SHAPE, F32, "cpu")
    legacy = autotune.legacy_cache_key(SHAPE, F32, "cpu")
    assert key.startswith(legacy) and autotune.runtime_version() in key
    assert autotune.runtime_version().startswith(f"torch{torch.__version__}+cuda")


def test_legacy_unversioned_entry_still_hits(cache):
    cache.write_text(json.dumps({autotune.legacy_cache_key(SHAPE, F32, "cpu"):
                                 {"block_m": 64, "block_n": 150}}))
    assert autotune.best_tiles(SHAPE, F32, "cpu") == {"block_m": 64, "block_n": 150}


def test_new_measurements_store_versioned(cache):
    autotune.measure_tiles(SHAPE, F32, "cpu", _fake_runner({"block_m": 64})[0])
    assert list(json.loads(cache.read_text())) == [autotune.cache_key(SHAPE, F32, "cpu")]
    autotune._MEM_CACHE.clear()
    assert autotune.best_tiles(SHAPE, F32, "cpu")["block_m"] == 64


def test_versioned_entry_wins_over_legacy(cache):
    cache.write_text(json.dumps({
        autotune.legacy_cache_key(SHAPE, F32, "cpu"): {"block_m": 64, "block_n": 100},
        autotune.cache_key(SHAPE, F32, "cpu"): {"block_m": 128, "block_n": 150},
    }))
    assert autotune.best_tiles(SHAPE, F32, "cpu") == {"block_m": 128, "block_n": 150}


def test_policy_autotune_optin_scopes_enablement(monkeypatch):
    assert not autotune.autotune_enabled()
    with autotune.forced(True):
        assert autotune.autotune_enabled()
        with autotune.forced(False):
            assert not autotune.autotune_enabled()
        assert autotune.autotune_enabled()
    assert not autotune.autotune_enabled()
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert autotune.autotune_enabled()
    with autotune.forced(False):
        assert not autotune.autotune_enabled()


@pytest.mark.parametrize("field,seen", [(None, False), (True, True), (False, False)])
def test_policy_autotune_reaches_the_plan_builder(monkeypatch, field, seen):
    """``MixerPolicy(autotune=...)`` scopes the opt-in around resolution; the
    plan builders see it through ``autotune_enabled``."""
    observed = []
    real = autotune.best_params

    def spy(*args, **kw):
        observed.append(autotune.autotune_enabled())
        return real(*args, **kw)

    monkeypatch.setattr(autotune, "best_params", spy)
    resolve_policy(MixerPolicy(backends=("packed",), autotune=field), SHAPE, device="cpu")
    assert observed == [seen]
    assert not autotune.autotune_enabled()


def test_describe_distinguishes_non_defaults():
    """test_policy.py::test_describe_distinguishes_non_defaults."""
    assert MixerPolicy().describe() == "MixerPolicy(auto)"
    assert "autotune=False" in MixerPolicy(autotune=False).describe()
    assert "requires_grad=True" in MixerPolicy(requires_grad=True).describe()
    assert MixerPolicy(autotune=False).describe() != MixerPolicy().describe()
    assert MixerPolicy(dtype=torch.bfloat16).describe() == "MixerPolicy(dtype=bfloat16)"
    assert MixerPolicy(precision="highest").describe() == "MixerPolicy(precision=highest)"
    with pytest.raises(ValueError, match="unknown dtype"):
        MixerPolicy(dtype="float99")


def test_policy_dtype_and_precision_resolve_as_in_the_reference(cache):
    """``dtype`` overrides the resolution dtype (the eligibility and the
    cache key), ``precision`` lands in the plan's params."""
    shape = MixerShape(1, 2, 3000, 16, 8)
    assert resolve_policy(MixerPolicy(), shape, F32, device="cuda").backend == "packed"
    # the fused kernels take fp32 and bf16 only: "auto" passes over them for fp16
    assert resolve_policy(MixerPolicy(dtype="float16"), shape, F32, device="cuda").backend \
        == "sdpa"
    cache.write_text(json.dumps({autotune.cache_key(shape, "bfloat16", "cuda", "packed"):
                                 {"block_m": 64, "block_n": 1000}}))
    autotune._MEM_CACHE.clear()
    bf16 = resolve_policy(MixerPolicy(dtype="bfloat16"), shape, F32, device="cuda")
    assert (bf16.params["block_m"], bf16.params["block_n"]) == (64, 1000)
    assert resolve_policy(MixerPolicy(), shape, F32, device="cuda").params["block_m"] == 256
    plan = resolve_policy(MixerPolicy(backends=("pallas",), precision="highest"), shape,
                          device="cuda")
    assert plan.params["precision"] == "highest" and plan.describe().endswith(
        ";precision=highest)")
    # the JAX package takes the same spellings
    for kw in ({"autotune": True}, {"dtype": "bfloat16"}, {"precision": "highest"}):
        assert resolve_policy(MixerPolicy(**kw), shape, F32, device="cuda").backend == "packed"
        JPolicy(**kw)


def test_store_merges_concurrent_writers(cache):
    """test_packed.py::test_store_merges_concurrent_writers."""
    autotune.measure_tiles(SHAPE, F32, "cpu", lambda t: 0.001)
    data = json.loads(cache.read_text())
    data["other|proc|key"] = {"block_m": 1, "block_n": 2}
    cache.write_text(json.dumps(data))
    shape2 = MixerShape(1, 2, 600, 32, 8)
    autotune.measure_tiles(shape2, F32, "cpu", lambda t: 0.001)
    final = json.loads(cache.read_text())
    assert "other|proc|key" in final
    assert autotune.cache_key(SHAPE, F32, "cpu") in final
    assert autotune.cache_key(shape2, F32, "cpu") in final


@pytest.mark.parametrize("content", [
    "{ not json !!",
    "[1, 2, 3]",
    json.dumps({"@": {"block_m": "??"}}),                 # the key is filled in below
    json.dumps({"@": {"block_m": 256}}),                  # partial
    json.dumps({"@": {"block_m": 96, "block_n": 37}}),    # a row tile the library lacks
    json.dumps({"@": {"block_m": 128, "block_n": 0}}),    # no split
])
def test_corrupt_or_malformed_cache_is_a_miss(cache, content):
    """test_packed.py::test_corrupt_cache_falls_back_to_heuristic and
    test_malformed_entry_is_a_miss: the defaults, never an error, and a store
    over a corrupt file recovers it."""
    shape = MixerShape(1, 2, 37, 8, 16)
    cache.write_text(content.replace("@", autotune.cache_key(shape, F32, "cpu")))
    misses = autotune._M_MISSES.value
    assert autotune.best_tiles(shape, F32, "cpu") == autotune.default_tiles(shape)
    assert autotune._M_MISSES.value == misses + 1
    autotune.measure_tiles(shape, F32, "cpu", lambda t: 0.001)
    assert autotune.cache_key(shape, F32, "cpu") in json.loads(cache.read_text())


def test_raising_candidate_loses_the_race():
    """A candidate whose runner raises (the wrappers refuse it) loses; with
    none left the defaults come back and nothing is stored."""
    def runner(params):
        if params["block_m"] != 64:
            raise ValueError("refused")
        return 0.001

    assert autotune.measure_tiles(SHAPE, F32, "cpu", runner)["block_m"] == 64
    assert autotune.measure_tiles(SHAPE, F32, "cpu", lambda p: 1 / 0, kind="packed") == \
        autotune.default_packed(SHAPE)


def test_counters_count_hits_misses_and_sweeps(cache):
    before = {m.name: m.value for m in (autotune._M_HITS, autotune._M_MISSES,
                                         autotune._M_MEASURED)}
    runner, _ = _fake_runner({"block_m": 64})
    with autotune.forced(True):
        autotune.best_tiles(SHAPE, F32, "cpu", runner=runner)    # miss, measured
    autotune.best_tiles(SHAPE, F32, "cpu", runner=runner)        # hit
    after = {m.name: m.value for m in (autotune._M_HITS, autotune._M_MISSES,
                                        autotune._M_MEASURED)}
    assert {k: after[k] - before[k] for k in after} == {
        "autotune.cache_hits": 1, "autotune.cache_misses": 1, "autotune.measured": 1}


def test_autotune_keys_gain_mesh_component():
    """test_mesh_parallel.py::test_autotune_keys_gain_mesh_component."""
    plain = autotune.cache_key(SHAPE, F32, "cpu", "packed")
    meshed = autotune.cache_key(SHAPE, F32, "cpu", "packed", mesh=(2, 2))
    assert "|mesh2x2|" in meshed and "mesh" not in plain
    assert plain == autotune.cache_key(SHAPE, F32, "cpu", "packed", mesh=None)
    assert autotune.legacy_cache_key(SHAPE, F32, "cpu", "packed",
                                     mesh=(2, 2)).endswith("|mesh2x2")


def test_packed_shard_plan_keys_the_per_shard_shape(cache):
    """The shard plan looks up the per-shard shape under the mesh key: a
    winner stored there reaches it, and no one-device entry does."""
    from repro_torch.backends.packed_shard import build_shard_plan

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (4, 1)[dim]

    shape = MixerShape(1, 2, 12000, 16, 8)
    local = MixerShape(1, 2, 3000, 16, 8)
    cache.write_text(json.dumps({
        autotune.cache_key(local, F32, "cpu", "packed", mesh=(4, 1)):
            {"block_m": 64, "block_n": 1500},
        autotune.cache_key(local, F32, "cpu", "packed"): {"block_m": 128, "block_n": 3000},
    }))
    plan = build_shard_plan(shape, Mesh(), ("data",), ("model",), F32, "cpu")
    assert (plan.params["block_m"], plan.params["block_n"]) == (64, 1500)
    assert plan.params["shape"] == local
    assert plan.describe().endswith("block_n=1500;block_m=64;mesh_shape=data4xmodel1)")


# --- parity with the JAX package and the kernels' rules -----------------------


@pytest.mark.parametrize("kind", ["tiles", "packed"])
@pytest.mark.parametrize("mesh", [None, (2, 2), (4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_legacy_key_matches_the_reference(kind, mesh, dtype):
    """For the same shape, dtype, device, kind and mesh the un-versioned key
    is the reference's, letter for letter."""
    shape = MixerShape(8, 8, 40000, 2048, 8)
    jshape = jdispatch.MixerShape(batch=8, heads=8, tokens=40000, latents=2048, head_dim=8)
    for device in ("cpu", "NVIDIA H100 80GB HBM3"):
        assert autotune.legacy_cache_key(shape, getattr(torch, dtype), device, kind, mesh) == \
            jautotune.legacy_cache_key(jshape, getattr(jnp, dtype), device, kind, mesh)


def _row_tiles(d: int) -> int:
    """csrc/flare.cu::row_tiles<D>() at D's MMA width."""
    return 4 if d <= 8 else 2 if d <= 16 else 1


def _flare_encode_splits(groups: int, m: int, n: int, sms: int) -> int:
    """csrc/flare.cu::flare_encode_splits, transcribed (C integer division)."""
    blocks = groups * ((m + 255) // 256)
    wave = sms * 4
    splits = wave // blocks if wave // blocks < n // 1024 else n // 1024
    return splits if splits > 1 else 1


@pytest.mark.parametrize("d", range(1, 65))
def test_default_rows_reproduce_row_tiles(d):
    shape = MixerShape(2, 4, 5000, 64, d)
    assert autotune.default_tiles(shape)["block_m"] == 64 * _row_tiles(d)
    assert autotune.default_packed(shape)["block_m"] == 64 * _row_tiles(d)
    assert kflare.default_rows(d) in kflare.row_choices(d)
    assert all(c["block_m"] in kflare.row_choices(d) for c in autotune.tile_candidates(shape))


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_default_split_reproduces_the_kernel_rule(sms):
    """The defaults' split is flare_encode_splits' over a sweep that holds
    pde_40k and pde_1m, and block_n = ceil(N / splits) gives those splits
    back."""
    shapes = [MixerShape(8, 8, 40000, 2048, 8), MixerShape(1, 8, 1048576, 2048, 8)]
    shapes += [MixerShape(b, h, n, m, 8) for b in (1, 2, 8) for h in (1, 4, 8)
               for n in (97, 1024, 4096, 40000, 300000) for m in (16, 300, 2048)]
    for s in shapes:
        want = _flare_encode_splits(s.batch * s.heads, s.latents, s.tokens, sms)
        assert kflare.default_splits(s.batch * s.heads, s.latents, s.tokens, sms) == want
        block_n = autotune.default_tiles(s, sms)["block_n"]
        assert -(-s.tokens // block_n) == want, s
    assert autotune.default_tiles(shapes[0], 132)["block_n"] == 40000          # one split
    assert autotune.default_tiles(shapes[1], 132)["block_n"] == 1048576 // 8   # eight


def test_candidates_are_what_the_wrappers_accept():
    for shape in (MixerShape(8, 8, 40000, 2048, 8), MixerShape(1, 8, 1048576, 2048, 8),
                  MixerShape(2, 2, 3000, 16, 16), MixerShape(1, 1, 97, 4, 40)):
        for kind in ("tiles", "packed"):
            cands = autotune._CANDIDATES[kind](shape)
            assert autotune._DEFAULTS[kind](shape) in cands
            assert len({tuple(sorted(c.items())) for c in cands}) == len(cands)
            for c in cands:
                kflare.check_tiles("test", shape.head_dim, shape.tokens, c["block_m"],
                                   c["block_n"])
    with pytest.raises(ValueError, match="block_m=96"):
        kflare.check_tiles("test", 8, 100, 96, None)
    with pytest.raises(ValueError, match="block_m=256"):
        kflare.check_tiles("test", 16, 100, 256, None)
    with pytest.raises(ValueError, match="block_n"):
        kflare.check_tiles("test", 8, 100, None, 0)


def _qkv(b=2, h=2, m=16, n=2100, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((h, m, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, h, n, d)) * 0.5).astype(np.float32),
            rng.standard_normal((b, h, n, d)).astype(np.float32))


@pytest.mark.parametrize("backend,kind", [("pallas", "tiles"), ("packed", "packed")])
def test_any_candidate_plan_matches_the_default_plan_and_jax(backend, kind):
    """A plan naming any candidate's parameters gives the default plan's
    output on the CPU (the plain versions have no tiles), within 1e-5 of the
    JAX mixer."""
    q, k, v = _qkv()
    want = np.asarray(jflare.flare_mixer(*map(jnp.asarray, (q, k, v)),
                                         policy=JPolicy(backends=("sdpa",))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    shape = MixerShape.from_qkv(tq, tk)
    default = resolve(backend, shape=shape, dtype=F32, device="cpu")[1]
    assert default.params["shape"] == shape
    y0 = run_plan(default, tq, tk, tv)
    cands = autotune._CANDIDATES[kind](shape)
    assert len(cands) == 6     # 3 row tiles x 1 or 2 splits (the default: 2)
    for params in cands:
        y = run_plan(MixerPlan(backend, {**params, "shape": shape}), tq, tk, tv)
        torch.testing.assert_close(y, y0, atol=0, rtol=0)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="block_m=32"):
        run_plan(MixerPlan(backend, {"block_m": 32, "block_n": 100}), tq, tk, tv)


def test_a_call_at_another_shape_takes_the_cache_or_its_defaults(cache):
    """A plan's parameters are for the shape it was resolved at; a call at
    another shape gets the cache's winner for that shape, or none (the
    kernels' defaults for the call)."""
    q, k, _ = map(torch.from_numpy, _qkv())
    at = MixerShape.from_qkv(q, k)
    plan = resolve("packed", shape=MixerShape(1, 2, 4096, 16, 8), dtype=F32, device="cpu")[1]
    assert autotune.launch_params(plan, q, k, "packed") == {}
    cache.write_text(json.dumps({autotune.cache_key(at, F32, "cpu", "packed"):
                                 {"block_m": 64, "block_n": 1050}}))
    autotune._MEM_CACHE.clear()
    assert autotune.launch_params(plan, q, k, "packed") == {"block_n": 1050, "block_m": 64}
    own = resolve("packed", shape=at, dtype=F32, device="cpu")[1]
    assert autotune.launch_params(own, q, k, "packed") == {"block_n": 1050, "block_m": 64}
    bare = MixerPlan("packed", {"block_m": 128, "block_n": 700})
    assert autotune.launch_params(bare, q, k, "packed") == {"block_n": 700, "block_m": 128}
