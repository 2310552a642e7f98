"""The port's encoder-decoder (the ``encdec`` / ``audio`` family,
seamless-m4t-large-v2, ``models/transformer.py``) against the JAX package.

The smoke config in both encoder variants (attention, and FLARE with
``encoder_mixer="flare"``) is drawn by the JAX package, its zero leaves
(layernorm biases, q/k/v biases, the FLARE output bias) given random
values so that every term reaches the logits, and carried into the port
with ``interop``. Source frames and tokens are drawn with numpy from a
seed. Tolerances, as tests/test_torch_lm.py: the logits (forward, prefill,
three decode steps), the loss and each gradient leaf at 1e-4 in fp32
compute, the cached K/V rows within one bf16 ulp; in bf16 compute the
logits, the loss, the memory and the cached rows at 2e-2 of the JAX
value's max magnitude. A bf16 gradient leaf is held against the fp32 JAX
gradient, no further from it than twice the JAX package's own bf16
gradient is, nor than 2e-2 of its max: the two packages' bf16 gradients
differ by up to 5.0e-2 of a leaf's max (the FLARE encoder's
``q_latent``, its gradient a sum of two terms that round apart), and the
JAX package's own compiled and op-by-op (``jax.disable_jit()``) bf16
gradients by up to 2.6e-2, so a bf16 leaf is held by what the reference
itself reaches (the port at up to 1.8 times the JAX bf16 error).
The FLARE encoder's ``packed`` and ``pallas``
policies (the kernels' plain versions on CPU tensors) against ``sdpa`` at
1e-5; ``impl="pallas"`` (the flash kernel's plain version here, Pallas
interpret mode in JAX) against JAX's pallas route at 1e-4. Then the
configs, the full-size parameter counts, the model API, interop and the
two launchers."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_large_v2 as jseamless
from repro.models import transformer as jt
from repro.models.api import get_model as jget_model
from repro_torch.config import replace
from repro_torch.configs import seamless_m4t_large_v2 as tseamless
from repro_torch.core.policy import MixerPolicy
from repro_torch.interop import (
    _jax_leaves,
    encdec_caches_from_jax,
    from_jax_flat,
    load_jax_params,
    to_jax_flat,
    unstack_layers,
)
from repro_torch.models import transformer as tt
from repro_torch.models.api import get_model
from repro_torch.nn.modules import count_params

from test_torch_rwkv import bf16_close, held, perturb

ARCH = "seamless_m4t_large_v2"
MIXERS = ("attn", "flare")
DTYPES = ("float32", "bfloat16")
SIZES = {"attn": 2_035_232_768, "flare": 2_217_881_600}
B, S_SRC, T, CAPACITY, DECODE_STEPS = 2, 24, 10, 16, 3
_PARAMS, _MODELS, _JAX_GRADS = {}, {}, {}


def params(mixer: str):
    """(JAX params, port net) of the smoke config with the ``mixer``
    encoder: fp32 parameters, the same whatever the compute dtype."""
    if mixer not in _PARAMS:
        jm = jget_model(jseamless.smoke_config(mixer))
        jp = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), seed=1)
        net = load_jax_params(get_model(tseamless.smoke_config(mixer), device="cpu").init(0),
                              unstack_layers(jp))
        _PARAMS[mixer] = (jax.tree.map(jnp.asarray, jp), net)
    return _PARAMS[mixer]


def models(mixer: str, dtype: str = "float32"):
    """(JAX model, JAX params, port model, port net) for the smoke config
    with the ``mixer`` encoder in ``dtype`` compute, on the same weights;
    the JAX entry points jitted."""
    key = (mixer, dtype)
    if key not in _MODELS:
        jm = jget_model(dataclasses.replace(jseamless.smoke_config(mixer), compute_dtype=dtype))
        tm = get_model(replace(tseamless.smoke_config(mixer), compute_dtype=dtype), device="cpu")
        jm = dataclasses.replace(jm, forward=jax.jit(jm.forward), loss=jax.jit(jm.loss),
                                 prefill=jax.jit(jm.prefill, static_argnums=2),
                                 decode_step=jax.jit(jm.decode_step))
        _MODELS[key] = (jm, params(mixer)[0], tm, params(mixer)[1])
    return _MODELS[key]


def jax_grads(mixer: str, dtype: str, jb) -> tuple:
    """(loss, every gradient leaf as a port ``state_dict`` key) of the JAX
    loss on ``jb`` in ``dtype`` compute."""
    if (mixer, dtype) not in _JAX_GRADS:
        jm, jp, _, _ = models(mixer, dtype)
        loss, grads = jax.value_and_grad(jm.loss)(jp, jb)
        _JAX_GRADS[mixer, dtype] = loss, from_jax_flat(
            _jax_leaves(unstack_layers(jax.tree.map(np.asarray, grads))))
    return _JAX_GRADS[mixer, dtype]


def batch(vocab: int, d_model: int, *, t: int = T, seed: int = 3) -> tuple:
    """(port batch, JAX batch): standard normal source frames [B, S_SRC, C]
    and tokens / labels [B, t], from numpy."""
    rng = np.random.default_rng(seed)
    arrays = {"embeds": rng.standard_normal((B, S_SRC, d_model)).astype(np.float32),
              "tokens": rng.integers(0, vocab, (B, t)).astype(np.int32),
              "labels": rng.integers(0, vocab, (B, t)).astype(np.int32)}
    port = {k: torch.from_numpy(v) if k == "embeds" else torch.from_numpy(v).long()
            for k, v in arrays.items()}
    return port, {k: jnp.asarray(v) for k, v in arrays.items()}




@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_configs_match_jax(mixer, which):
    """Every field the port keeps equals the JAX config's, the attention
    config's too."""
    got, want = getattr(tseamless, which)(mixer), getattr(jseamless, which)(mixer)
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        if f.name == "attn":
            assert {k: getattr(want.attn, k) for k in dataclasses.asdict(value)} == \
                dataclasses.asdict(value)
        else:
            assert value == getattr(want, f.name), f.name
    assert got.name == ("seamless-m4t-large-v2-flare" if mixer == "flare" and which == "config"
                        else want.name)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes, no data."""

    @property
    def device(self):
        return torch.device("meta")


@pytest.mark.parametrize("mixer", MIXERS)
def test_full_size_builds_with_jax_parameter_count(mixer):
    """The full config on the meta device: the JAX tree's parameter count
    (``jax.eval_shape`` of its init), the encoder's share, the entry points
    built without a card, the FLARE encoder's plans resolved in bf16 to the
    fused kernel."""
    cfg = tseamless.config(mixer)
    net = tt.init_encdec(cfg, generator=_MetaGenerator(), device="meta")
    jtree = jax.eval_shape(jget_model(jseamless.config(mixer)).init, jax.random.PRNGKey(0))
    assert count_params(net) == sum(x.size for x in jax.tree.leaves(jtree)) == SIZES[mixer]
    assert count_params(net.encoder) == sum(x.size for x in jax.tree.leaves(jtree["encoder"]))
    m = get_model(cfg)
    if mixer == "flare":
        assert {k: p.backend for k, p in m.plans.items()} == {"infer": "packed",
                                                               "train": "packed"}
    else:
        assert m.plans == {}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mixer", MIXERS)
def test_forward_loss_and_grads_match_jax(mixer, dtype):
    """Teacher-forced logits (the padded vocab sliced off), the loss, and
    every parameter's gradient per leaf."""
    jm, jp, tm, net = models(mixer, dtype)
    tb, jb = batch(tm.cfg.vocab, tm.cfg.d_model)
    got, aux = tm.forward(net, tb)
    want, _ = jm.forward(jp, jb)
    assert got.shape == (B, T, tm.cfg.vocab) and got.dtype == torch.float32 and float(aux) == 0
    held(got, want, dtype)
    net.zero_grad()
    loss = tm.loss(net, tb)
    loss.backward()
    grads = {name: p.grad.clone() for name, p in net.named_parameters()}
    net.zero_grad()
    jloss, wants = jax_grads(mixer, dtype, jb)
    held(loss, jloss, dtype)
    assert sorted(grads) == sorted(wants)
    if dtype == "bfloat16":   # the JAX bf16 leaf's distance from the fp32 gradient, x2
        _, exact = jax_grads(mixer, "float32", jb)
        limits = {name: max(2 * (wants[name] - g).abs().max().item(),
                            2e-2 * g.abs().max().item()) for name, g in exact.items()}
        wants = exact
    for name, g in grads.items():
        err = (g.double() - wants[name].double()).abs().max().item()
        limit = limits[name] if dtype == "bfloat16" else 1e-4
        assert err <= limit, f"{name}: max abs err {err:.3g} > {limit:.3g}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mixer", MIXERS)
def test_prefill_and_decode_match_jax(mixer, dtype):
    """Prefill, then DECODE_STEPS greedy steps on the JAX package's tokens:
    the logits of every step, and the caches (each layer's self K/V rows,
    the memory, pos) after each."""
    jm, jp, tm, net = models(mixer, dtype)
    tb, jb = batch(tm.cfg.vocab, tm.cfg.d_model, seed=5)
    tb.pop("labels"), jb.pop("labels")
    got, caches = tm.prefill(net, tb, CAPACITY)
    want, jc = jm.prefill(jp, jb, CAPACITY)
    assert got.shape == (B, tm.cfg.vocab) and got.dtype == torch.float32
    held(got, want, dtype)
    for step in range(DECODE_STEPS + 1):
        assert caches.pos.tolist() == np.asarray(jc.pos).tolist() == [T + step] * B
        mem = np.asarray(jc.memory, np.float32)
        assert caches.memory.dtype == getattr(torch, dtype)
        held(caches.memory.float(), mem, dtype)
        n = T + step
        for i, kv in enumerate(caches.self_caches):
            assert kv.k.dtype == torch.bfloat16 and kv.k.shape[2] == CAPACITY
            for got_rows, want_rows in ((kv.k, jc.self_caches.k[i]), (kv.v, jc.self_caches.v[i])):
                want_rows = np.asarray(want_rows[:, :, :n], np.float32)
                if dtype == "float32":
                    bf16_close(got_rows[:, :, :n], want_rows, 1e-4)
                else:
                    held(got_rows[:, :, :n].float(), want_rows, dtype)
            assert kv.length.tolist() == np.asarray(jc.self_caches.length[i]).tolist()
        if step == DECODE_STEPS:
            break
        tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
        got, caches = tm.decode_step(net, torch.from_numpy(tok).long(), caches)
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        held(got, want, dtype)


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_step_from_jax_caches(mixer):
    """The JAX prefill's caches carried in by ``interop`` and advanced by one
    port decode step: the JAX decode step's logits at 1e-4, and pos."""
    jm, jp, tm, net = models(mixer)
    _, jb = batch(tm.cfg.vocab, tm.cfg.d_model, seed=7)
    jb.pop("labels")
    want, jc = jm.prefill(jp, jb, CAPACITY)
    caches = encdec_caches_from_jax(jax.tree.map(np.asarray, jc))
    assert len(caches.self_caches) == tm.cfg.num_layers
    tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    got, caches = tm.decode_step(net, torch.from_numpy(tok).long(), caches)
    want, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
    held(got, want, "float32")
    assert caches.pos.tolist() == np.asarray(jc.pos).tolist()


@pytest.mark.parametrize("mixer", MIXERS)
def test_pallas_prefill_matches_jax(mixer):
    """``impl="pallas"`` routes the encoder's, the decoder's and the
    cross-attention through the flash kernel (its plain version on CPU
    tensors) against JAX's pallas route; then a decode step after it."""
    jm, jp, tm, net = models(mixer)
    tb, jb = batch(tm.cfg.vocab, tm.cfg.d_model, seed=8)
    with torch.no_grad():
        got, caches = tt.encdec_prefill(net, tb, tm.cfg, CAPACITY, impl="pallas",
                                        plan=tm.plans.get("infer"))
    want, jc = jt.encdec_prefill(jp, {"embeds": jb["embeds"], "tokens": jb["tokens"]}, jm.cfg,
                                 CAPACITY, impl="pallas", mixer_plan=jm.plans.get("infer"))
    held(got, want, "float32")
    tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    held(tm.decode_step(net, torch.from_numpy(tok).long(), caches)[0],
         jm.decode_step(jp, jnp.asarray(tok), jc)[0], "float32")


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_flare_encoder_policies_match_sdpa(backend):
    """The FLARE encoder under the kernels' policies (their plain versions
    on CPU tensors) against the plain ``sdpa``: the memory and the logits."""
    _, _, tm, net = models("flare")
    kernel = get_model(tm.cfg, policy=MixerPolicy(backends=(backend,)), device="cpu")
    plain = get_model(tm.cfg, policy=MixerPolicy(backends=("sdpa",)), device="cpu")
    assert kernel.plans["infer"].backend == backend
    tb, _ = batch(tm.cfg.vocab, tm.cfg.d_model, seed=9)
    with torch.no_grad():
        mem = tt.encode(net, tb["embeds"], tm.cfg, plan=kernel.plans["infer"])
        want = tt.encode(net, tb["embeds"], tm.cfg, plan=plain.plans["infer"])
    torch.testing.assert_close(mem, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(kernel.forward(net, tb)[0], plain.forward(net, tb)[0],
                               atol=1e-5, rtol=0)


def test_interop_round_trip():
    """The stacked ``encoder`` and ``decoder`` in both directions, the FLARE
    leaves under ``attn`` and the ResMLP's list kept."""
    jm, jp, tm, net = models("flare")
    flat = to_jax_flat(net.state_dict())
    want = _jax_leaves(jax.tree.map(np.asarray, jp))
    assert sorted(flat) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(flat[key], arr)
    assert flat["encoder/attn/q_latent"].shape == (2, 4, 16, 16)
    assert flat["decoder/cross_attn/wq/bias"].shape == (2, 64)
    back = from_jax_flat(flat)
    assert sorted(back) == sorted(net.state_dict())
    assert "encoder.1.attn.k_proj.res.2.weight" in back and "enc_norm.bias" in back
    for name, t in net.state_dict().items():
        torch.testing.assert_close(back[name], t, atol=0, rtol=0)


def test_model_api():
    """No slot-pool serving path (the caches need the memory), as in JAX;
    the attention encoder resolves no plan, the FLARE one resolves on the
    CPU to ``sdpa``; an inference-only policy builds and refuses ``loss``."""
    for mixer in MIXERS:
        m = get_model(tseamless.smoke_config(mixer), device="cpu")
        jm = jget_model(jseamless.smoke_config(mixer))
        assert m.init_caches is m.prefill_into is m.prefill_suffix is None
        assert jm.init_caches is None and jm.prefill_into is None
        assert m.prefill is not None and m.decode_step is not None
        assert sorted(m.plans) == sorted(jm.plans)
        assert all(p.backend == "sdpa" for p in m.plans.values())
    m = get_model(tseamless.smoke_config("flare"), policy=MixerPolicy(backends=("pallas",)),
                  device="cpu")
    tb, _ = batch(m.cfg.vocab, m.cfg.d_model)
    with pytest.raises(ValueError, match="cannot train"):
        m.loss(m.init(0), tb)


def test_inference_only_model_keeps_no_caller_frame():
    """A model built with an inference-only policy keeps its resolve error
    for ``loss`` without the error's traceback, whose frames would reach the
    caller's locals (on the card, a model's weights) and keep them alive
    until a gc pass."""
    import gc
    import weakref

    def build():
        weights = torch.zeros(4)
        model = get_model(tseamless.smoke_config("flare"),
                          policy=MixerPolicy(backends=("pallas",)), device="cpu")
        return weakref.ref(weights), model

    gc.disable()
    try:
        ref, model = build()
        assert ref() is None
    finally:
        gc.enable()
    with pytest.raises(ValueError, match="cannot train"):
        model.loss(None, {})


def test_serve_launcher_refuses_with_jax_message(monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    msgs = []
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    msgs.append(str(exc.value))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit) as exc:
        jserve.main()
    msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "seamless-smoke has no slot-pool serving path (family=audio)"


def test_train_launcher_feeds_the_jax_launchers_batches(monkeypatch, tmp_path, capsys):
    """Both launchers' step-keyed batches for steps 0 and 1 are equal (the
    JAX trainer stubbed), then the port's launcher trains 2 steps."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    seen = {}

    def stub(name):
        class Stub:
            def __init__(self, *a, **kw):
                pass

            def fit(self, batch_fn):
                seen[name] = [batch_fn(step) for step in (0, 1)]
                return []
        return Stub

    args = ["--arch", ARCH, "--smoke", "--steps", "2", "--seq-len", "16", "--global-batch", "2",
            "--ckpt", str(tmp_path / "ckpt")]
    monkeypatch.setattr(jtrain, "Trainer", stub("jax"))
    monkeypatch.setattr(sys, "argv", ["train", *args])
    jtrain.main()
    monkeypatch.setattr(ttrain, "Trainer", stub("port"))
    ttrain.main(args + ["--device", "cpu"])
    for jb, tb in zip(seen["jax"], seen["port"]):
        assert sorted(jb) == sorted(tb) == ["embeds", "labels", "tokens"]
        for key in jb:
            np.testing.assert_array_equal(np.asarray(jb[key]), np.asarray(tb[key]))
        assert tb["embeds"].dtype == np.float32 and tb["embeds"].shape == (2, 16, 64)
    monkeypatch.undo()
    ttrain.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "seamless-smoke: 2 steps, loss" in out
