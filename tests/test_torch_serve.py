"""The port's serving stack against the JAX package's, and its own contracts.

The engine: the same greedy tokens as the JAX ``ServeEngine`` on the smoke
qwen2 in fp32 compute (its weights carried with ``interop``), dense and
paged; the dense pool, the paged pool's gather route and its kernel route
token-identical, with the stats naming each route, no host sampling and
every block returned (the counterparts of tests/test_paged_pool.py's
``test_paged_engine_bit_identical`` and ``test_kernel_decode_bit_identical``).
On CPU tensors the kernel route runs the paged kernel's plain version. The
int8 / fp8 pools' first-step logits are held against the dense pool within
tests/test_paged_pool.py's envelope (atol 0.15, rtol 0.05). The allocator,
quantization, sampler, cache discovery and the launcher are tested alone."""
import dataclasses
import json
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
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.interop import load_jax_params, unstack_layers
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.api import get_model
from repro_torch.serve import ModelSlotCache, slot_axes
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pool import BlockAllocator, PagedModelCache, get_quant
from repro_torch.serve.pool.quant import dequantize, quantize
from repro_torch.serve.pool.views import gather_leaf, scatter_blocks
from repro_torch.serve.sampling import make_sampler

REPO = Path(__file__).resolve().parents[1]
GEOMETRY = dict(capacity=32, slots=2)
PAGED = dict(pool_tokens=96, block_size=8)
_MODELS = {}


def _qwen2():
    """The smoke qwen2 in fp32 compute, in both packages, on the same weights."""
    if "qwen2" not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke("qwen2_1_5b"), compute_dtype="float32"))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(replace(get_smoke_config("qwen2_1_5b"), compute_dtype="float32"),
                       device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(jax.tree.map(np.asarray, jp)))
        _MODELS["qwen2"] = (jm, jp, tm, net)
    return _MODELS["qwen2"]


def _requests(vocab, n=5, seed=0, lo=3, hi=14):
    """tests/test_paged_pool.py's request mix."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    max_new = rng.integers(3, 11, n)
    return [(rng.integers(0, vocab, lens[i]).astype(np.int32), int(max_new[i]))
            for i in range(n)]


def _serve(engine, reqs):
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    return [o.tolist() for o in engine.run_all()]


def _drained(engine):
    engine.check_invariants()
    st = engine.stats["pool"]
    assert st["blocks_free"] == st["blocks_total"] and st["blocks_reserved"] == 0


# --- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_engine_matches_jax_engine(pool):
    jm, jp, tm, net = _qwen2()
    reqs = _requests(tm.cfg.vocab)
    kw = dict(GEOMETRY, **(PAGED if pool == "paged" else {}))
    want = [o.tolist() for o in (lambda e: (
        [e.submit(p, max_new_tokens=m) for p, m in reqs], e.run_all())[1])(
            JServeEngine(jm, jp, **kw))]
    assert _serve(ServeEngine(tm, net, **kw), reqs) == want


def test_routes_token_identical():
    """Dense pool, paged gather and paged kernel route: the same greedy
    tokens; stats name the routes; the kernel route reads through the paged
    kernel's wrapper (its plain version here, no launch counted), samples
    on the device and returns every block."""
    _, _, tm, net = _qwen2()
    reqs = _requests(tm.cfg.vocab)
    engines = {"dense": ServeEngine(tm, net, **GEOMETRY),
               "gather": ServeEngine(tm, net, **GEOMETRY, **PAGED, decode_backend="gather"),
               "kernel": ServeEngine(tm, net, **GEOMETRY, **PAGED, decode_backend="paged"),
               "auto": ServeEngine(tm, net, **GEOMETRY, **PAGED)}
    before = launch_counts()
    outs = {name: _serve(eng, reqs) for name, eng in engines.items()}
    assert launch_counts() == before
    assert outs["gather"] == outs["dense"] and outs["kernel"] == outs["dense"]
    assert outs["auto"] == outs["dense"]
    assert engines["dense"].stats["decode_backend"] == "dense"
    assert engines["gather"].stats["decode_backend"] == "paged-gather"
    assert engines["kernel"].stats["decode_backend"] == "paged(block=8;quant=none)"
    assert engines["auto"].stats["decode_backend"] == "paged(block=8;quant=none)"
    for name in ("gather", "kernel"):
        eng = engines[name]
        assert eng.stats["sample_host_syncs"] == 0 and eng.stats["finished"] == len(reqs)
        assert eng.stats["pool"]["pages_appended"] > 0    # decode crossed block boundaries
        _drained(eng)


def test_flare_lm_serves_through_dense_pool():
    """flare_lm's decode state is O(M) latents, no token axis: the paged pool
    holds it all dense, "auto" resolves to the dense step, forcing the
    kernel route raises; its tokens equal the dense pool's."""
    tm = get_model(get_smoke_config("flare_lm"), device="cpu")
    net = tm.init(0)
    reqs = _requests(tm.cfg.vocab, n=3)
    paged = ServeEngine(tm, net, **GEOMETRY, **PAGED)
    assert not paged.slot_cache.spec.paged
    assert _serve(paged, reqs) == _serve(ServeEngine(tm, net, **GEOMETRY), reqs)
    assert paged.stats["decode_backend"] == "dense"
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tm, net, **GEOMETRY, **PAGED, decode_backend="paged")


def test_admission_backpressure_in_pages():
    """A pool smaller than the working set throttles admission (peak below
    the slots), every request completes with the dense pool's tokens, and
    the pool drains back to free."""
    _, _, tm, net = _qwen2()
    reqs = _requests(tm.cfg.vocab, n=6)
    tiny = ServeEngine(tm, net, capacity=32, slots=3, pool_tokens=32, block_size=8)
    assert _serve(tiny, reqs) == _serve(ServeEngine(tm, net, capacity=32, slots=3), reqs)
    assert tiny.stats["finished"] == len(reqs) and tiny.stats["admitted_peak"] < 3
    _drained(tiny)
    wide = ServeEngine(tm, net, capacity=64, slots=1, pool_tokens=32, block_size=8)
    with pytest.raises(ValueError, match="7 pages but the pool only has 4"):
        wide.submit(np.zeros(20, np.int32), max_new_tokens=30)   # a request that could never stake


def test_eos_and_deadline():
    """A request stops at its eos token; one still queued past its deadline
    is dropped without a slot or a page, and the rest run as they would."""
    _, _, tm, net = _qwen2()
    (p0, _), (p1, _), (p2, _) = _requests(tm.cfg.vocab, n=3)
    ref = ServeEngine(tm, net, capacity=32, slots=1, **PAGED)
    first = _serve(ref, [(p0, 6)])[0]
    eng = ServeEngine(tm, net, capacity=32, slots=1, **PAGED)
    eng.submit(p0, max_new_tokens=6, eos_id=first[2])
    eng.submit(p1, max_new_tokens=4, deadline_s=0.0)   # waits behind p0's one slot
    eng.submit(p2, max_new_tokens=3)
    outs = [o.tolist() for o in eng.run_all()]
    assert outs[0] == first[:first.index(first[2]) + 1] and outs[1] == [] and len(outs[2]) == 3
    assert eng.stats["dropped"] == 1 and eng.stats["finished"] == 2
    _drained(eng)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_pool_logits_within_envelope(quant):
    """int8 / fp8 storage: the first decode step's logits against the dense
    pool's, within tests/test_paged_pool.py's int8 envelope (atol 0.15,
    rtol 0.05); a token's row costs one byte an element plus an fp32 scale."""
    _, _, tm, net = _qwen2()
    reqs = _requests(tm.cfg.vocab, n=3, lo=6)
    logits = {}
    for name, kw in (("dense", {}), (quant, dict(PAGED, kv_quant=quant))):
        eng = ServeEngine(tm, net, **GEOMETRY, **kw)
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new_tokens=max_new)
        eng.step()
        logits[name] = eng.last_logits.numpy()
        eng.run_all()
    np.testing.assert_allclose(logits[quant], logits["dense"], atol=0.15, rtol=0.05)
    assert eng.stats["decode_backend"] == f"paged(block=8;quant={quant})"
    cfg = tm.cfg
    rows = 2 * cfg.num_layers * cfg.attn.num_kv_heads      # K and V of each layer and KV head
    assert eng.slot_cache.token_bytes_paged() == rows * (cfg.attn.head_dim + 4)
    assert eng.slot_cache.token_bytes_dense() == rows * cfg.attn.head_dim * 2
    _drained(eng)


def test_engine_samples_on_device_reproducibly():
    """top-k sampling: a seed gives the same tokens twice, every token lies
    in its step's top k, and another seed draws other tokens."""
    _, _, tm, net = _qwen2()
    reqs = _requests(tm.cfg.vocab, n=3)
    run = lambda seed: _serve(ServeEngine(tm, net, **GEOMETRY, **PAGED, sample="topk",
                                          top_k=3, temperature=2.0, seed=seed), reqs)
    assert run(7) == run(7)
    assert run(7) != run(8)


# --- sampler, allocator, quantization, discovery -----------------------------------


def test_sampler_greedy_topk_and_seed():
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(0))
    greedy, needs = make_sampler(0.0)
    assert not needs and torch.equal(greedy(logits, None), logits.argmax(-1).to(torch.int32))
    topk, needs = make_sampler(1.5, "topk", top_k=4)
    assert needs
    draw = lambda fn, seed: fn(logits, torch.Generator().manual_seed(seed))
    tok = draw(topk, 1)
    assert tok.dtype == torch.int32
    allowed = logits.topk(4, dim=-1).indices
    assert (allowed == tok[:, None].long()).any(-1).all()
    assert torch.equal(tok, draw(topk, 1)) and not torch.equal(tok, draw(topk, 2))
    temp, _ = make_sampler(1.0)
    assert len(set(draw(temp, 3).tolist())) > 10     # it samples, not argmax
    with pytest.raises(ValueError, match="top_k"):
        make_sampler(1.0, "topk")


def test_allocator_reserve_map_append_release():
    a = BlockAllocator(6, 8)
    assert a.can_reserve(6) and not a.can_reserve(7)
    lease = a.reserve(4)
    assert a.available() == 2
    assert a.map(lease, 2) == [0, 1]              # lowest ids first
    assert a.append(lease) == 2 and a.pages_appended == 1
    a.check_invariants(external_refs={0: 1, 1: 1, 2: 1})
    assert a.stats()["blocks_peak_mapped"] == 3
    a.release(lease)
    assert a.available() == 6 and a.mapped_blocks() == 0
    a.check_invariants(external_refs={})


def test_allocator_no_double_free_and_no_overmap():
    a = BlockAllocator(4, 8)
    lease = a.reserve(2)
    a.map(lease, 2)
    a.release(lease)
    with pytest.raises(RuntimeError, match="free"):
        a.release(dataclasses.replace(lease, mapped=[0, 1], reserved=0))
    with pytest.raises(RuntimeError, match="exhausted"):
        a.reserve(5)
    with pytest.raises(RuntimeError, match="reserved"):
        a.map(a.reserve(1), 2)
    with pytest.raises(RuntimeError, match="sanitizer"):
        a.check_invariants(external_refs={3: 1})


def test_quantization_bounds():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32) * 3)
    x[2] = 0                                           # a zero row is safe
    none = get_quant("none")
    q, s = quantize(none, x.bfloat16())
    assert s is None and torch.equal(dequantize(none, q, s, torch.bfloat16), x.bfloat16())
    amax = x.abs().amax(-1, keepdim=True)
    for name, bound in (("int8", amax / (2 * 127) + 1e-7), ("fp8", amax / 16)):
        spec = get_quant(name)
        q, s = quantize(spec, x)
        assert q.dtype == spec.store_dtype and s.shape == (5,)
        back = dequantize(spec, q, s, torch.float32)
        assert (back - x).abs().le(bound).all(), name
        assert not back[2].any() and torch.isfinite(back).all()
    with pytest.raises(ValueError, match="unknown kv quant"):
        get_quant("int4")


def test_slot_discovery_and_dense_reset():
    """Slot axes come from meta-device builds; reset restores a slot's init
    values, FLARE's -inf running max included."""
    tm = get_model(get_smoke_config("flare_lm"), device="cpu")
    axes = slot_axes(tm.init_caches, 32)
    assert axes == [0] * len(axes)
    cache = ModelSlotCache(tm.init_caches, 32)
    pool = cache.init(3)
    for leaf in (pool.layers[0].m_max, pool.layers[1].num, pool.pos):
        leaf.fill_(5)
    cache.reset(pool, torch.tensor([1]))
    assert torch.isneginf(pool.layers[0].m_max[1]).all() and (pool.layers[0].m_max[0] == 5).all()
    assert not pool.layers[1].num[1].any() and pool.pos.tolist() == [5, 0, 5]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_discovery_and_block_round_trip(quant):
    """qwen2's K and V of each layer are paged (token axis 2, rest [Hkv, D]),
    lengths and positions dense; a leaf scattered into pages gathers back."""
    _, _, tm, _ = _qwen2()
    pc = PagedModelCache(tm.init_caches, 32, pool_tokens=96, block=8, quant=quant)
    spec = pc.spec
    assert len(spec.paged) == 2 * tm.cfg.num_layers
    assert all((m.slot_axis, m.token_axis, m.view) == (0, 2, 32) for m in spec.paged)
    pool = pc.init(2)
    assert pool["data"][0].shape == (13, 8, 2, 8)
    leaf = torch.randn(1, 2, 32, 8).bfloat16()
    ids = torch.tensor([[5, 2, 9, 0]])
    scatter_blocks(pool["data"][0], pool["scale"][0], leaf, ids, spec.paged[0], spec)
    back = gather_leaf(pool["data"][0], pool["scale"][0], ids, spec.paged[0], spec)
    tol = 0 if quant == "none" else leaf.float().abs().amax().item() / 127
    torch.testing.assert_close(back.float(), leaf.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["paged", "prefix"])
def test_launch_serve_smoke_on_cpu(case, tmp_path):
    """The paged pool; then the prefix cache on a shared-prefix workload
    with pinned templates, coalesced prefill, a trace and the metrics (the
    pin's one-token probes are requests of their own)."""
    extra = {"paged": ["--pool-tokens", "96", "--block-size", "8"],
             "prefix": ["--pool-tokens", "192", "--block-size", "8", "--capacity", "64",
                        "--prompt-len", "24", "--prefix-cache", "--share-prefix", "2",
                        "--pin-prompt", "--coalesce", "--trace-out", str(tmp_path / "t.json"),
                        "--metrics-out", str(tmp_path / "m.json")]}[case]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2_1_5b", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4", *extra],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "decode backend: paged(block=8;quant=none)" in out.stdout
    if case == "paged":
        assert "3 requests / 12 tokens" in out.stdout
        assert "0/12 blocks mapped" in out.stdout and "12 free after the run" in out.stdout
        return
    assert "pinned 6 template blocks" in out.stdout and "5 requests / 14 tokens" in out.stdout
    assert "prefix cache: enabled=True" in out.stdout and "cow_copies=1" in out.stdout
    assert "hit_rate=0.000" not in out.stdout and "pinned=6" in out.stdout
    trace = json.loads((tmp_path / "t.json").read_text())
    assert {"enqueue", "admit", "prefill", "decode", "retire", "prefix_hit", "cow_copy"} <= {
        e["name"] for e in trace["traceEvents"]}
    assert json.loads((tmp_path / "m.json").read_text())["metrics"]["engine.prefix_hit_tokens"] > 0
