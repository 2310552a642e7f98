"""The serving engine's warmup and its decode step as one capturable
function (``ServeEngine(cuda_graph=True)``, the default) on the CPU, where
the static-buffer step runs directly each step, with no capture.

The port of tests/test_serve_continuous.py's
``test_warmup_precompiles_decode_and_prefill``, case for case; the static
step's greedy tokens against the eager step's (``cuda_graph=False``) and
the JAX engine's on the same weights, for gqa (dense pool, paged gather,
paged kernel view), ``flare_lm`` and the smoke DeepSeek-V2-Lite (MLA +
MoE); the pool keeping every address through admissions, retirements,
prefix hits and copy-on-write copies; a replaced pool tensor caught; the
launch counters a replay adds; the launcher's ``--warmup
--max-decode-compiles 0``. Capture and replay on the card are in
tests/test_torch_gpu.py."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import get_model as jget_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import AttnConfig, ModelConfig, replace
from repro_torch.configs import get_smoke_config
from repro_torch.interop import load_jax_params, unstack_layers
from repro_torch.kernels import ops
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.api import get_model
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import ServeEngine

REPO = Path(__file__).resolve().parents[1]
GEOMETRY = dict(capacity=32, slots=2)
PAGED = dict(pool_tokens=96, block_size=8)
_MODELS = {}


def _gqa_cfg():
    """tests/test_serve_continuous.py's gqa model."""
    return ModelConfig(name="t", family="dense", num_layers=2, d_model=64, d_ff=128, vocab=64,
                       attn=AttnConfig("gqa", num_heads=4, num_kv_heads=2, head_dim=16),
                       remat="none")


def _gqa():
    if "gqa" not in _MODELS:
        model = get_model(_gqa_cfg(), device="cpu")
        _MODELS["gqa"] = (model, model.init(0))
    return _MODELS["gqa"]


def _pair(arch):
    """(JAX model, its params, the port's model, its net) of a smoke arch in
    fp32 compute, on the same weights."""
    if arch not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke(arch), compute_dtype="float32"))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = get_model(replace(get_smoke_config(arch), compute_dtype="float32"), device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(jax.tree.map(np.asarray, jp)))
        _MODELS[arch] = (jm, jp, tm, net)
    return _MODELS[arch]


def _requests(vocab, n=5, seed=0, lo=3, hi=14):
    """tests/test_serve_continuous.py's request mix."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    max_new = rng.integers(2, 11, n)
    return [(rng.integers(0, vocab, lens[i]).astype(np.int32), int(max_new[i]))
            for i in range(n)]


def _serve(engine, reqs):
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    return [np.asarray(o).tolist() for o in engine.run_all()]


def _addresses(engine):
    leaves = torch.utils._pytree.tree_leaves(engine.pool)
    return [t.data_ptr() for t in leaves if t is not None]


# --- warmup ---------------------------------------------------------------------


def test_warmup_precompiles_decode_and_prefill():
    """warmup() front-loads every (bucket, lanes) prefill and the decode
    step; the serving loop afterwards adds zero decode builds and zero
    prefill variants, and the warmup stats record the work."""
    model, params = _gqa()
    eng = ServeEngine(model, params, capacity=32, slots=2, pool_tokens=96, block_size=8)
    n = eng.warmup(max_prompt_len=16)
    assert n > 0 and eng.stats["warmup_compiles"] == n
    compiles_after_warmup = eng._decode_compiles
    pre_compiles = eng.stats["prefill_compiles"]
    for prompt, mn in _requests(model.cfg.vocab, n=4):
        eng.submit(prompt[:14], max_new_tokens=mn)
    eng.run_all()
    assert eng._decode_compiles == compiles_after_warmup   # steady state: 0 new
    assert eng.stats["prefill_compiles"] == pre_compiles
    assert eng.stats["decode_compiles"] == compiles_after_warmup


@pytest.mark.parametrize("pool", ["dense", "paged", "prefix", "eager"])
def test_warmup_counts_and_leaves_no_trace(pool):
    """The counts JAX's warmup gives (buckets 8 and 16, one lane; with the
    prefix cache the two suffix buckets and the COW copy; the decode build,
    none on the eager step), the gauges under JAX's names, the tracer's
    ``warmup`` span; the greedy tokens equal those of an engine never
    warmed (every slot reset after); a second warmup builds nothing but
    the COW copy, which JAX's counts each time."""
    model, params = _gqa()
    kw = {"dense": {}, "paged": PAGED, "prefix": dict(PAGED, prefix_cache=True),
          "eager": dict(PAGED, cuda_graph=False)}[pool]
    reqs = [(p[:14], m) for p, m in _requests(model.cfg.vocab, n=4)]
    tracer = Tracer()
    eng = ServeEngine(model, params, **GEOMETRY, tracer=tracer, **kw)
    n = eng.warmup(max_prompt_len=16)
    builds = 0 if pool == "eager" else 1
    assert n == 2 + (3 if pool == "prefix" else 0) + builds
    assert eng.stats["decode_compiles"] == builds and eng.stats["warmup_s"] > 0
    assert eng.stats["prefill_compiles"] == 2 + (2 if pool == "prefix" else 0)
    snap = eng.metrics.snapshot()
    assert snap["engine.decode_compiles"] == builds
    assert snap["engine.prefill_compiles"] == eng.stats["prefill_compiles"]
    spans = [s for s in tracer.events if s.name == "warmup"]
    assert len(spans) == 1 and spans[0].args == {"compiles": n}
    assert _serve(eng, reqs) == _serve(ServeEngine(model, params, **GEOMETRY, **kw), reqs)
    assert eng.stats["decode_compiles"] == builds
    assert eng.warmup(max_prompt_len=16) == (pool == "prefix")   # JAX counts the COW copy again


def test_warmup_consumes_no_entropy_and_refuses_live_slots():
    """top-k sampling: a warmed engine draws the tokens an unwarmed one of
    the same seed draws; warmup with a request in a slot raises."""
    model, params = _gqa()
    reqs = _requests(model.cfg.vocab, n=3)
    kw = dict(GEOMETRY, **PAGED, sample="topk", top_k=3, temperature=2.0, seed=5)
    warm = ServeEngine(model, params, **kw)
    warm.warmup(max_prompt_len=16)
    assert _serve(warm, reqs) == _serve(ServeEngine(model, params, **kw), reqs)
    eng = ServeEngine(model, params, **kw)
    eng.submit(reqs[0][0], max_new_tokens=4)
    eng.step()
    with pytest.raises(RuntimeError, match="before serving"):
        eng.warmup()


# --- the static step against the eager step and the JAX engine -----------------------


ROUTES = {"gqa-dense": ("qwen2_1_5b", {}),
          "gqa-gather": ("qwen2_1_5b", dict(PAGED, decode_backend="gather")),
          "gqa-kernel": ("qwen2_1_5b", dict(PAGED, decode_backend="paged")),
          "flare_lm": ("flare_lm", {}),
          "deepseek-kernel": ("deepseek_v2_lite_16b", dict(PAGED, decode_backend="paged"))}


@pytest.mark.parametrize("route", list(ROUTES))
def test_static_step_matches_eager_and_jax(route):
    """fp32 compute: the static-buffer step's greedy tokens equal the eager
    step's and the JAX engine's, across admissions, retirements and block
    crossings; the static step is built once, the eager one never; every
    pool address holds through the run."""
    arch, kw = ROUTES[route]
    jm, jp, tm, net = _pair(arch)
    reqs = _requests(tm.cfg.vocab, n=4)
    static = ServeEngine(tm, net, **GEOMETRY, **kw)
    before = _addresses(static)
    got = _serve(static, reqs)
    eager = ServeEngine(tm, net, **GEOMETRY, **kw, cuda_graph=False)
    assert got == _serve(eager, reqs)
    assert got == _serve(JServeEngine(jm, jp, **GEOMETRY, **kw), reqs)
    assert static.stats["decode_compiles"] == 1 and eager.stats["decode_compiles"] == 0
    assert _addresses(static) == before
    assert static.stats["sample_host_syncs"] == 0 and static.stats["finished"] == len(reqs)


def test_pool_keeps_its_addresses_through_hits_and_cow():
    """A prefix-cache run that admits, retires, hits shared blocks and
    copies one on write: every pool tensor and static input buffer keeps
    its data_ptr(), and the step is built once."""
    _, _, tm, net = _pair("qwen2_1_5b")
    eng = ServeEngine(tm, net, capacity=64, slots=2, pool_tokens=192, block_size=8,
                      prefix_cache=True, decode_backend="paged")
    rng = np.random.default_rng(4)
    template = rng.integers(0, tm.cfg.vocab, 24).astype(np.int32)
    prompts = [template] + [np.concatenate([template, rng.integers(0, tm.cfg.vocab, k)])
                            .astype(np.int32) for k in (3, 5, 2)]
    before = _addresses(eng) + [eng._tok_in.data_ptr(), eng._wpos.data_ptr(),
                                eng._pt_dev.data_ptr()]
    eng.submit(prompts[0], max_new_tokens=3)
    eng.run_all()
    for p in prompts + [template]:
        eng.submit(p, max_new_tokens=5)
    eng.run_all()
    st = eng.stats
    assert st["cow_copies"] >= 1 and st["prefix_hit_rate"] > 0 and st["finished"] == 6
    assert _addresses(eng) + [eng._tok_in.data_ptr(), eng._wpos.data_ptr(),
                              eng._pt_dev.data_ptr()] == before
    assert st["decode_compiles"] == 1
    eng.check_invariants()


@pytest.mark.parametrize("what", ["dense leaf", "block storage", "page table"])
def test_replaced_pool_tensor_is_caught(what):
    """After the step is built, a pool tensor or input buffer put in place
    of the one it holds makes the next step raise (a captured graph would
    read the old address)."""
    _, _, tm, net = _pair("qwen2_1_5b")
    eng = ServeEngine(tm, net, **GEOMETRY, **PAGED, decode_backend="paged")
    reqs = _requests(tm.cfg.vocab, n=2, lo=6)
    for prompt, _ in reqs:
        eng.submit(prompt, max_new_tokens=8)
    eng.step()
    assert eng.stats["decode_compiles"] == 1
    if what == "dense leaf":
        eng.pool = {**eng.pool, "dense": tuple(t.clone() for t in eng.pool["dense"])}
    elif what == "block storage":
        eng.pool = {**eng.pool, "data": (eng.pool["data"][0].clone(), *eng.pool["data"][1:])}
    else:
        eng._pt_dev = eng._pt_dev.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        eng.step()


# --- the launch counters a replay adds ---------------------------------------------


def test_count_snapshot_delta_and_add():
    """A capture's launches (a delta of two snapshots, per wrapper and
    route) taken back once and added on each of N replays leave the
    counters at N times one step's launches."""
    ops.reset_launch_counts()
    before = ops.count_snapshot()
    paged_attention.launches += 3
    paged_attention.launches_by_route["decode"] += 3
    flash_attention.launches += 1
    flash_attention.launches_by_route["tensor_core"] += 1
    delta = ops.count_delta(before, ops.count_snapshot())
    assert delta == {(paged_attention, None): 3, (paged_attention, "decode"): 3,
                     (flash_attention, None): 1, (flash_attention, "tensor_core"): 1}
    ops.add_launches(delta, -1)
    assert not any(ops.launch_counts().values())
    for _ in range(4):
        ops.add_launches(delta)
    assert ops.launch_counts()["paged_attention"] == 12
    assert paged_attention.launches_by_route["decode"] == 12
    assert flash_attention.launches_by_route["tensor_core"] == 4
    ops.reset_launch_counts()


# --- the launcher ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["warm", "bound broken", "eager"])
def test_launch_warmup_and_decode_compile_bound(case):
    """``--warmup --max-decode-compiles 0`` on the CPU exits 0 with no
    build while serving and no host sync; without ``--warmup`` the first
    step builds the decode step and the bound of 0 exits non-zero;
    ``--no-cuda-graph`` serves on the eager step, which builds nothing."""
    flags = {"warm": ["--warmup", "--max-decode-compiles", "0"],
             "bound broken": ["--max-decode-compiles", "0"],
             "eager": ["--no-cuda-graph", "--max-decode-compiles", "0"]}[case]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2_1_5b", "--smoke",
         "--device", "cpu", "--requests", "6", "--max-new", "12", "--capacity", "32",
         "--slots", "4", "--pool-tokens", "96", "--block-size", "8", "--decode-backend",
         "paged", *flags],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    if case == "bound broken":
        assert out.returncode != 0 and "compiled 1x while serving (bound 0)" in out.stderr
        return
    assert out.returncode == 0, out.stderr
    assert "decode backend: paged(" in out.stdout and "host syncs/step: 0.0" in out.stdout
    if case == "warm":
        assert "warmup: 3 programs compiled" in out.stdout
        assert "decode compiles: 1 total, 0 while serving" in out.stdout
    else:
        assert "decode compiles: 0 total, 0 while serving" in out.stdout
