"""The port's prefix cache against the JAX package's, and its own contracts.

``chain_hashes`` byte-equal to JAX's; the port's block allocator and JAX's
run one script of operations each and agree on refcounts, free list, index
and results at every step; ``gqa_extend`` and ``lm_prefill_suffix`` within
1e-5 (fp32) and 2e-2 (bf16) of max |JAX|; the port's engine with
``prefix_cache=True`` gives the JAX engine's greedy tokens on the smoke
qwen2 with the weights carried by ``interop``. Then the engine's contracts,
the counterparts of tests/test_prefix_cache.py: tokens equal with the cache
on and off (bf16 compute, where the suffix path stages every reduction as
the full prefill does), copy-on-write at a block boundary and on an exact
template, pins against eviction pressure, int8 / fp8 pools sharing on token
ids, ``flare_lm`` switching the cache off, references given back on a
deadline drop and on a rejected submit, and a control: a hit whose first
shared page points at another live block must change the tokens. Every
engine built here is checked by its sanitizer (external references) at
teardown."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.models.api import get_model as jget_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.pool import BlockAllocator as JBlockAllocator
from repro.serve.pool.blocks import chain_hashes as jchain_hashes
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.interop import load_jax_params, unstack_layers
from repro_torch.models import attention, transformer
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pool import BlockAllocator
from repro_torch.serve.pool.blocks import chain_hashes

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # max |port - JAX| over max |JAX|
_MODELS = {}


@pytest.fixture(autouse=True)
def _sanitize_engines(monkeypatch):
    """Every engine built in a test is held to its sanitizer at teardown."""
    engines = []
    orig = ServeEngine.__init__

    def recording_init(self, *a, **k):
        orig(self, *a, **k)
        engines.append(self)

    monkeypatch.setattr(ServeEngine, "__init__", recording_init)
    yield
    for eng in engines:
        eng.check_invariants()


def _qwen2(dtype="float32"):
    """The smoke qwen2 in ``dtype`` compute in both packages, same weights."""
    if dtype not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke("qwen2_1_5b"), compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(replace(get_smoke_config("qwen2_1_5b"), compute_dtype=dtype), device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(jax.tree.map(np.asarray, jp)))
        _MODELS[dtype] = (jm, jp, tm, net)
    return _MODELS[dtype]


def _template(n=40, lo=1, hi=50):
    return (np.arange(1, n + 1, dtype=np.int32) * 7) % (hi - lo) + lo


def _engine(dtype="bfloat16", *, prefix=True, slots=1, pool_blocks=24, block=8, quant="none",
            capacity=64, **kw):
    _, _, tm, net = _qwen2(dtype)
    return ServeEngine(tm, net, capacity=capacity, slots=slots, pool_tokens=pool_blocks * block,
                       block_size=block, kv_quant=quant, prefix_cache=prefix, **kw)


def _run(eng, prompts, max_new=6):
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_all()
    outs = {r.rid: list(r.tokens) for r in eng.sched.finished}
    return [outs[r] for r in rids]


def _rel(got, want) -> float:
    """max |got - want| over max |want|; got a torch tensor, want a JAX array."""
    got = got.detach().double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- chain hashes and the allocator against JAX --------------------------------------


@pytest.mark.parametrize("n,block", [(43, 8), (64, 16), (7, 8), (1792, 16)])
def test_chain_hashes_byte_equal_jax(n, block):
    tokens = np.random.default_rng(n).integers(0, 151_000, n).astype(np.int32)
    assert chain_hashes(tokens, block) == jchain_hashes(tokens, block)
    assert len(chain_hashes(tokens, block)) == n // block   # full blocks only


H = jchain_hashes(_template(16), 8)   # two chained hashes
# Scripts of allocator operations: (lease name or None, method, args); a
# string arg names a lease made earlier, ("poke", block, refcount) corrupts
# the refcount to reach the underflow branch.
SCRIPTS = {
    "share_release": (6, [("A", "reserve", (2,)), (None, "map", ("A", 2)),
                          (None, "register", (0, H[0])), (None, "lookup", (H[0],)),
                          (None, "acquire", (0,)), (None, "ref", (0,)),
                          (None, "shared_blocks", ()), (None, "release", ("A",)),
                          (None, "release_ref", (0,)), (None, "lookup", (H[0],))]),
    "double_free_underflow": (4, [("A", "reserve", (1,)), (None, "map", ("A", 1)),
                                  (None, "release_ref", (0,)), (None, "release_ref", (0,)),
                                  (None, "release_ref", (3,)), ("B", "reserve", (1,)),
                                  (None, "map", ("B", 1)), ("poke", 0, 0),
                                  (None, "release_ref", (0,))]),
    "resurrect_margin": (2, [("A", "reserve", (1,)), (None, "map", ("A", 1)),
                             (None, "register", (0, H[0])), (None, "release", ("A",)),
                             (None, "acquire", (0,)), (None, "ref", (0,)),
                             (None, "release_ref", (0,)), (None, "acquire", (0, 2)),
                             (None, "acquire", (0, 1)), (None, "acquire", (0, 0)),
                             (None, "release_ref", (0,))]),
    "remap_evicts_stale_hash": (2, [("A", "reserve", (1,)), (None, "map", ("A", 1)),
                                    (None, "register", (0, H[0])), (None, "release", ("A",)),
                                    ("B", "reserve", (1,)), (None, "map", ("B", 1)),
                                    (None, "lookup", (H[0],)), (None, "release", ("B",))]),
    "keep_first_registration": (4, [("A", "reserve", (3,)), (None, "map", ("A", 2)),
                                    (None, "register", (0, H[0])), (None, "register", (1, H[0])),
                                    (None, "register", (1, H[1])), (None, "register", (0, H[1])),
                                    (None, "lookup", (H[0],)), (None, "lookup", (H[1],)),
                                    (None, "append", ("A",)), (None, "release", ("A",))]),
}


def _state(a) -> dict:
    return {"free": list(a._free), "ref": dict(a._ref), "index": dict(a._by_hash),
            "hash_of": dict(a._hash_of), "reserved": a._reserved, "stats": a.stats()}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_allocator_matches_jax(script):
    blocks, ops = SCRIPTS[script]
    allocs = {"port": BlockAllocator(blocks, 8), "jax": JBlockAllocator(blocks, 8)}
    trails = {}
    for side, alloc in allocs.items():
        leases, trail = {}, []
        for op in ops:
            if op[0] == "poke":
                alloc._ref[op[1]] = op[2]
                continue
            name, method, args = op
            args = tuple(leases[x] if isinstance(x, str) else x for x in args)
            try:
                out = getattr(alloc, method)(*args)
                if name:
                    leases[name] = out
                    out = dataclasses.astuple(out)
            except RuntimeError as e:
                out = ("raised", " ".join(str(e).split()[:3]))
            trail.append((method, out, _state(alloc)))
        trails[side] = trail
    assert trails["port"] == trails["jax"]
    assert any(out[0] == "raised" for _, out, _ in trails["port"] if isinstance(out, tuple)) \
        == (script == "double_free_underflow")


# --- the model side against JAX ------------------------------------------------------


def _jax_layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_extend_matches_jax(dtype):
    jm, jp, tm, net = _qwen2(dtype)
    cfg = tm.cfg.attn
    rng = np.random.default_rng(1)
    b, s, cap = 2, 8, 32
    x = rng.standard_normal((b, s, tm.cfg.d_model)).astype(np.float32)
    k0 = rng.standard_normal((b, cfg.num_kv_heads, cap, cfg.head_dim)).astype(np.float32)
    v0 = rng.standard_normal(k0.shape).astype(np.float32)
    offsets, lengths = np.array([5, 11], np.int32), np.array([3, 8], np.int32)
    pos = offsets[:, None] + np.arange(s, dtype=np.int32)[None]
    jcache = jattention.KVCache(jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16),
                                jnp.asarray(offsets))
    jy, jc = jattention.gqa_extend(_jax_layer0(jp)["attn"], jnp.asarray(x, dtype), cfg, jcache,
                                   positions=jnp.asarray(pos), offsets=jnp.asarray(offsets),
                                   lengths=jnp.asarray(lengths))
    tcache = attention.KVCache(torch.from_numpy(k0).bfloat16(), torch.from_numpy(v0).bfloat16(),
                               torch.from_numpy(offsets))
    ty, tc = attention.gqa_extend(net.layers[0].attn, torch.from_numpy(x).to(getattr(torch, dtype)),
                                  cfg, tcache, positions=torch.from_numpy(pos),
                                  offsets=torch.from_numpy(offsets),
                                  lengths=torch.from_numpy(lengths))
    assert _rel(ty, jy) <= TOL[dtype]
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        assert _rel(got, want) <= TOL[dtype]
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [8, 19]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_suffix_matches_jax(dtype):
    """The prefix's caches from JAX's prefill, continued by 3 and 6 suffix
    tokens in both packages: the logits and the caches agree."""
    jm, jp, tm, net = _qwen2(dtype)
    full = [_template(43), _template(46, lo=3, hi=60)]
    offsets, lens = np.array([40, 40], np.int32), np.array([3, 6], np.int32)
    toks = np.zeros((2, 40), np.int32)
    for i, t in enumerate(full):
        toks[i] = t[:40]
    _, jcaches = jm.prefill(jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(offsets)}, 64)
    sfx = np.zeros((2, 8), np.int32)
    for i, t in enumerate(full):
        sfx[i, :lens[i]] = t[40:]
    jbatch = {"tokens": jnp.asarray(sfx), "lengths": jnp.asarray(lens),
              "offsets": jnp.asarray(offsets)}
    jlogits, jout = jtransformer.lm_prefill_suffix(jp, jbatch, jcaches, jm.cfg)
    layers = [attention.KVCache(torch.from_numpy(np.asarray(jcaches.layers.k[i], np.float32)).bfloat16(),
                                torch.from_numpy(np.asarray(jcaches.layers.v[i], np.float32)).bfloat16(),
                                torch.from_numpy(np.array(jcaches.layers.length[i])))
              for i in range(tm.cfg.num_layers)]
    tbatch = {"tokens": torch.from_numpy(sfx).long(), "lengths": torch.from_numpy(lens),
              "offsets": torch.from_numpy(offsets)}
    tlogits, tout = tm.prefill_suffix(net, tbatch,
                                      transformer.LMCaches([], layers, torch.from_numpy(offsets)))
    assert _rel(tlogits, jlogits) <= TOL[dtype]
    assert _rel(tout.layers[-1].k, jout.layers.k[-1]) <= TOL[dtype]
    assert tout.pos.tolist() == np.asarray(jout.pos).tolist() == [43, 46]


# --- the engine -------------------------------------------------------------------------


def test_engine_matches_jax_engine():
    """Donor, a cold prompt, the exact template (copy-on-write), two
    partial hits; fp32 compute, 2 slots: the port's greedy tokens and prefix
    stats are the JAX engine's."""
    jm, jp, tm, net = _qwen2("float32")
    t = _template(40)
    prompts = [t, _template(13, lo=60, hi=90), t.copy(),
               np.concatenate([t, [9, 3]]).astype(np.int32),
               np.concatenate([t[:20], [4, 5, 6]]).astype(np.int32)]
    kw = dict(capacity=64, slots=2, pool_tokens=192, block_size=8, prefix_cache=True)
    jeng = JServeEngine(jm, jp, **kw)
    want = _run(jeng, prompts)
    jeng._refresh_stats()
    eng = ServeEngine(tm, net, **kw)
    assert _run(eng, prompts) == want
    for key in ("prefix_hit_rate", "cow_copies"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["cow_copies"] == 1 and eng.stats["prefix_hit_rate"] > 0.4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_on_off_equal(dtype):
    """Greedy tokens equal with the cache on and off, the on-run hitting."""
    t = _template(40)
    prompts = [np.concatenate([t, np.array(tail, np.int32)]) for tail in ([7], [9], [9, 3, 22])]
    on = _engine(dtype, prefix=True)
    outs_on = _run(on, prompts)
    off = _engine(dtype, prefix=False)
    assert outs_on == _run(off, prompts)
    assert on.stats["prefix_hit_rate"] > 0 and off.stats["prefix_hit_rate"] == 0.0


def test_cow_divergence_at_block_boundary():
    """A suffix that starts on a block boundary keeps every hit block shared:
    no copy-on-write."""
    t = _template(40)
    prompts = [np.concatenate([t, np.array([x], np.int32)]) for x in (7, 9)]
    eng = _engine()
    outs = _run(eng, prompts)
    assert eng.stats["prefix_hit_rate"] > 0 and eng.stats["cow_copies"] == 0
    assert outs == _run(_engine(prefix=False), prompts)


def test_cow_exact_template_reuse():
    """Full coverage copies the last hit block into a private page; the
    shared source stays intact for the next tenant."""
    t = _template(40)
    prompts = [t.copy(), t.copy(), np.concatenate([t, np.array([9], np.int32)])]
    eng = _engine()
    outs = _run(eng, prompts)
    assert eng.stats["cow_copies"] == 1 and outs[0] == outs[1]
    assert outs == _run(_engine(prefix=False), prompts)


def test_pinned_prefix_survives_eviction_pressure():
    """Pinned template blocks survive a pool churning through every free
    block and still give a cold run's tokens; an unpinned control loses its
    index entries to the same churn."""
    t = _template(40)
    rng = np.random.default_rng(11)
    churn = [rng.integers(0, 50, 41).astype(np.int32) for _ in range(6)]
    probe = np.concatenate([t, np.array([9], np.int32)])
    pinned = _engine(slots=2)
    assert pinned.pin_prefix(t) == 5
    _run(pinned, churn, max_new=4)
    hits = pinned.alloc.prefix_hits
    outs = _run(pinned, [probe])
    assert pinned.alloc.prefix_hits > hits
    assert outs == _run(_engine(prefix=False, slots=2), [probe])
    pinned.release_pins()
    assert pinned.alloc.stats()["blocks_free"] == 24 and not pinned._pins

    ctrl = _engine(slots=2)
    _run(ctrl, [t], max_new=1)   # registered, not pinned
    _run(ctrl, churn, max_new=4)
    hits = ctrl.alloc.prefix_hits
    _run(ctrl, [probe])
    assert ctrl.alloc.prefix_hits == hits


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_pools_share_on_token_ids(quant):
    t = _template(40)
    eng = _engine(quant=quant)
    _run(eng, [np.concatenate([t, np.array([x], np.int32)]) for x in (7, 9)], max_new=4)
    assert eng.alloc.prefix_hits == 5 and eng.stats["prefix_hit_rate"] > 0


def test_flare_lm_switches_the_cache_off():
    tm = get_model(get_smoke_config("flare_lm"), device="cpu")
    net = tm.init(0)
    assert tm.prefill_suffix is None
    t = _template(24)
    prompts = [np.concatenate([t, np.array([x], np.int32)]) for x in (7, 9)]
    kw = dict(capacity=64, slots=2, pool_tokens=192, block_size=8)
    eng = ServeEngine(tm, net, prefix_cache=True, **kw)
    assert not eng.stats["prefix_cache"]
    assert _run(eng, prompts, max_new=4) == _run(ServeEngine(tm, net, **kw), prompts, max_new=4)
    assert eng.stats["prefix_hit_rate"] == 0.0


def test_references_returned_on_expiry_and_rejection():
    """A queued hit whose deadline expires, and a submit rejected as too
    large for the pool, give back the references their walks took."""
    t = _template(24)
    eng = _engine(pool_blocks=6)
    _run(eng, [t], max_new=1)                       # donor: 3 cached-free blocks
    eng.submit(np.concatenate([t, [3]]).astype(np.int32), max_new_tokens=4)
    rid = eng.submit(np.concatenate([t, [4]]).astype(np.int32), max_new_tokens=4,
                     deadline_s=-1.0)
    assert len(eng.sched.waiting[1].prefix_blocks) == 3   # the walk at submit holds them
    eng.check_invariants()
    with pytest.raises(ValueError, match="pages"):   # 8 pages > the pool's 6
        eng.submit(np.concatenate([t, [5]]).astype(np.int32), max_new_tokens=200)
    eng.check_invariants()
    assert eng.alloc.ref(eng.sched.waiting[0].prefix_blocks[0]) == 2
    eng.run_all()
    assert [r.rid for r in eng.sched.dropped] == [rid]
    st = eng.stats["pool"]
    assert st["blocks_free"] == st["blocks_total"] and st["blocks_reserved"] == 0


def test_control_corrupt_shared_page_is_caught():
    """The control the token-equality assertions rest on: a hit whose first
    shared page points at another live block must give other tokens."""
    t = _template(40)
    other = _template(40, lo=60, hi=120)
    prompts = [t, other, np.concatenate([t, np.array([9, 3], np.int32)])]
    cold = _run(_engine(prefix=False, slots=2), prompts)
    eng = _engine(slots=2)
    stake = eng._stake_suffix

    def corrupt(req, slot):
        stake(req, slot)
        donor = eng.alloc.lookup(chain_hashes(other, 8)[0])
        eng._pt[slot, 0] = donor       # the page table now reads the other prompt's rows
        eng._leases[slot].mapped[0], bad = donor, eng._leases[slot].mapped[0]
        eng.alloc.acquire(donor)
        eng.alloc.release_ref(bad)

    eng._stake_suffix = corrupt
    outs = _run(eng, prompts)
    assert eng.stats["prefix_hit_rate"] > 0
    assert outs[:2] == cold[:2] and outs[2] != cold[2]


def test_deadlock_fallback_drops_queued_holds():
    """A queued hit's holds (blocks brought back at submit) leave an idle
    pool too few pages for the cold request at the head of the queue: the
    engine drops every queued hold and admits the head cold, and both
    requests give a cold engine's tokens."""
    t = _template(24)
    head = _template(24, lo=60, hi=90)
    hit = np.concatenate([t, np.array([3], np.int32)])
    eng = _engine(pool_blocks=6)
    _run(eng, [t], max_new=1)                     # 3 cached-free blocks
    eng.submit(head, max_new_tokens=24)           # needs all 6 pages
    eng.submit(hit, max_new_tokens=4)             # its walk takes back the 3 blocks
    assert eng.alloc.available() == 3
    outs = [o.tolist() for o in eng.run_all()]
    cold = _engine(prefix=False, pool_blocks=6)
    assert outs == [o.tolist() for o in (cold.submit(head, max_new_tokens=24),
                                         cold.submit(hit, max_new_tokens=4), cold.run_all())[2]]
