"""The port's serving observability and the engine's other new surfaces,
against the JAX package's.

The ``Tracer`` and its Chrome export against ``repro.obs.trace``'s on one
event script; the engine's span tree (names, tracks, argument keys and
values, in recording order) against the JAX engine's for the same requests
with the prefix cache on; tracing changes no greedy token and adds no host
sync; a deadline drop is an ``expire`` instant; ``coalesce_prefill``
against the JAX engine's coalesced run in bf16 (the first decode step's
logits within 2e-2 of max |logit|, as the kernel routes' bf16 tolerance);
``on_token`` streams exactly the final outputs. The smoke qwen2, its
weights carried from the JAX tree with ``interop``."""
import dataclasses
import json

import jax
import numpy as np

from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import get_model as jget_model
from repro.obs.trace import Tracer as JTracer
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.interop import load_jax_params, unstack_layers
from repro_torch.models.api import get_model
from repro_torch.obs import NULL_TRACER, PHASES, TID_ENGINE, MetricsRegistry, Tracer
from repro_torch.serve.engine import ServeEngine

ROUTE_TOL = 2e-2   # bf16: max |port - JAX| over max |JAX|
KW = dict(capacity=64, pool_tokens=192, block_size=8)
_MODELS = {}


def _qwen2(dtype):
    if dtype not in _MODELS:
        jm = jget_model(dataclasses.replace(jget_smoke("qwen2_1_5b"), compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(replace(get_smoke_config("qwen2_1_5b"), compute_dtype=dtype), device="cpu")
        net = load_jax_params(tm.init(0), unstack_layers(jax.tree.map(np.asarray, jp)))
        _MODELS[dtype] = (jm, jp, tm, net)
    return _MODELS[dtype]


def _template(n=40, lo=1, hi=50):
    return (np.arange(1, n + 1, dtype=np.int32) * 7) % (hi - lo) + lo


def _drive(eng, prompts, max_new=6, deadlines=None, on_token=None):
    kw = {} if on_token is None else {"on_token": on_token}
    rids = [eng.submit(p, max_new_tokens=max_new,
                       deadline_s=None if deadlines is None else deadlines[i], **kw)
            for i, p in enumerate(prompts)]
    while eng.step():
        pass
    done = {r.rid: list(r.tokens) for r in eng.sched.finished + eng.sched.dropped}
    return [done[r] for r in rids]


def _script(tr):
    tr.set_track_name(TID_ENGINE, "engine")
    tr.set_track_name(2, "slot1")
    tr.complete("prefill", 100.25, 0.5, tid=2, args={"rids": [0, 1], "bucket": 16, "lanes": 2})
    tr.instant("enqueue", ts=100.0, args={"rid": 0, "prompt_len": 12})
    tr.complete("decode", 101.0, -1.0, args={"steps": 16, "tokens": 30})   # clamped to 0
    tr.instant("retire", ts=102.0, tid=2, args={"rid": 0, "tokens": 6})
    tr.complete("train_step", 100.5, 0.125, cat="train")


def test_tracer_matches_jax_tracer(tmp_path):
    port, ref = Tracer(), JTracer()
    _script(port)
    _script(ref)
    assert port.to_chrome(process_name="p") == ref.to_chrome(process_name="p")
    assert {k: [(e.ts, e.dur) for e in v] for k, v in port.by_phase().items()} == \
        {k: [(e.ts, e.dur) for e in v] for k, v in ref.by_phase().items()}
    with port.span("warmup", args={"n": 1}):
        pass
    assert port.events[-1].name == "warmup" and port.events[-1].ph == "X"
    assert port.write(str(tmp_path / "t.json")) == 6
    doc = json.loads((tmp_path / "t.json").read_text())
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts) and ts[0] == 0.0
    port.clear()
    assert port.events == [] and port.now() > 0
    off = Tracer(enabled=False)
    _script(off)
    with off.span("x"):
        pass
    assert off.events == [] and off.to_chrome()["traceEvents"][1:] == []
    assert NULL_TRACER.enabled is False and PHASES == ("enqueue", "admit", "prefill", "decode",
                                                       "retire")


def _tree(events):
    """(name, phase, track, args without the queue time) in recording order."""
    return [(e.name, e.ph, e.tid, {k: v for k, v in (e.args or {}).items() if k != "queue_s"})
            for e in events]


def test_engine_span_tree_matches_jax():
    """A cold donor, its exact template (a copy-on-write hit) and a partial
    hit, one slot, 20 new tokens each (more than one 16-step window)."""
    jm, jp, tm, net = _qwen2("float32")
    t = _template(40)
    prompts = [t, t.copy(), np.concatenate([t, _template(4, lo=50, hi=60)])]
    jtr, tr = JTracer(), Tracer()
    jeng = JServeEngine(jm, jp, slots=1, prefix_cache=True, tracer=jtr, **KW)
    want = _drive(jeng, prompts, max_new=20)
    reg = MetricsRegistry()
    eng = ServeEngine(tm, net, slots=1, prefix_cache=True, tracer=tr, metrics=reg, **KW)
    assert _drive(eng, prompts, max_new=20) == want
    assert _tree(tr.events) == _tree(jtr.events)
    by = tr.by_phase()
    assert all(by.get(ph) for ph in PHASES + ("prefix_walk", "prefix_hit", "cow_copy"))
    assert sum(e.args["steps"] for e in by["decode"]) == eng.stats["decode_steps"] > 16
    snap = reg.snapshot()
    assert snap["sched.admitted"] == 3 and snap["engine.cow_copies"] == 1
    assert snap["engine.prefix_hit_tokens"] > 0 and snap["pool.prefix_hits"] > 0
    assert snap["engine.tokens_out"] == eng.stats["tokens_generated"] == 60
    doc = tr.to_chrome()
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert names == {"engine", "slot0"}


def test_tracing_changes_no_token():
    _, _, tm, net = _qwen2("float32")
    prompts = [_template(40), _template(40),
               np.concatenate([_template(40), _template(3, lo=50, hi=60)])]
    base = ServeEngine(tm, net, slots=2, prefix_cache=True, **KW)
    tr = Tracer()
    traced = ServeEngine(tm, net, slots=2, prefix_cache=True, tracer=tr, **KW)
    assert _drive(base, prompts) == _drive(traced, prompts)
    assert base.tracer is NULL_TRACER and len(tr.events) > 0
    assert traced.stats["host_syncs_per_step"] == base.stats["host_syncs_per_step"] == 0.0
    traced.check_invariants()


def test_expire_instant_on_deadline_drop():
    _, _, tm, net = _qwen2("float32")
    tr = Tracer()
    eng = ServeEngine(tm, net, slots=1, tracer=tr, **KW)
    t = _template(24)
    outs = _drive(eng, [t, t, t], max_new=8, deadlines=[None, -1.0, None])
    assert outs[1] == [] and len(outs[0]) == len(outs[2]) == 8
    expires = [e for e in tr.events if e.name == "expire"]
    assert len(expires) == 1 and expires[0].args == {"rid": 1}
    assert eng.stats["expired_total"] == 1


def test_coalesce_matches_jax_coalesced():
    """Four cold admissions of one cycle, two buckets: two batched prefills
    in both packages; the first decode step's logits within the bf16
    tolerance of JAX's and of the port's solo run."""
    jm, jp, tm, net = _qwen2("bfloat16")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32) for n in (5, 7, 12, 14)]
    runs = {}
    for name, eng in (("jax", JServeEngine(jm, jp, slots=4, coalesce_prefill=True, **KW)),
                      ("port", ServeEngine(tm, net, slots=4, coalesce_prefill=True, **KW)),
                      ("solo", ServeEngine(tm, net, slots=4, **KW))):
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
        eng.step()
        runs[name] = (np.asarray(jax.numpy.asarray(eng.last_logits, "float32"))
                      if name == "jax" else eng.last_logits.float().numpy(),
                      eng.stats["coalesced_prefills"])
        while eng.step():
            pass
    want = runs["jax"][0]
    for name in ("port", "solo"):
        got = runs[name][0]
        assert np.abs(got - want).max() / np.abs(want).max() <= ROUTE_TOL, name
    assert runs["port"][1] == runs["jax"][1] == 2 and runs["solo"][1] == 0


def test_on_token_streams_the_outputs():
    _, _, tm, net = _qwen2("float32")
    streamed: dict = {}
    eng = ServeEngine(tm, net, slots=2, prefix_cache=True, **KW)
    prompts = [_template(20), _template(20), _template(9, lo=60, hi=90)]
    outs = _drive(eng, prompts, max_new=5,
                  on_token=lambda rid, tok: streamed.setdefault(rid, []).append(tok))
    assert [streamed[rid] for rid in range(3)] == outs
    assert all(len(o) == 5 for o in outs)


def test_dense_pool_traces_without_pages():
    """The dense pool traces the same lifecycle (no prefix events) and
    ignores ``prefix_cache``."""
    _, _, tm, net = _qwen2("float32")
    tr = Tracer()
    eng = ServeEngine(tm, net, capacity=64, slots=2, prefix_cache=True, tracer=tr)
    _drive(eng, [_template(20), _template(20)], max_new=3)
    assert not eng.stats["prefix_cache"]
    assert set(tr.by_phase()) == set(PHASES)
