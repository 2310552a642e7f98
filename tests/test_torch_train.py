"""The port's training path against the JAX package: autograd through the
fused backend, AdamW and the schedule, the train step, checkpoints and the
trainer.

Inputs come from numpy with a seed and weights are carried over from the
JAX tree by ``repro_torch.interop``. Tolerances: gradients of the mixer
1e-5 (fp32 reference math on both sides); the AdamW update 1e-6 (one fp32
update, the bias corrections taken in fp64 by the port and fp32 by JAX);
the train step's loss and grad_norm 1e-4 relative per step over 3 steps,
and parameters 1e-4 after them: the two frameworks sum in fp32 in another
order (the first step agrees to 1e-7), and Adam divides each gradient by its
own RMS, which carries the difference of a small gradient into a whole
step of size lr (3e-3 here); 2.2e-5 was seen after three steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.config import TrainConfig as JTrainConfig
from repro.models.api import get_model as jget_model
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import init_adamw as jinit_adamw
from repro.optim.schedule import onecycle_schedule as jonecycle
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import flare as tflare
from repro_torch.core.policy import MixerPolicy
from repro_torch.interop import from_jax_flat, load_jax_params, to_jax_flat
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.api import get_model
from repro_torch.optim import adamw_update, init_adamw, onecycle_schedule
from repro_torch.train import Trainer, make_eval_step, make_train_step


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke_pair(seed=0, policy=None):
    """The JAX smoke model with its params, and the port's with the same weights."""
    jm = jget_model(jconfigs.get_smoke_config("flare_pde"))
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = get_model(get_smoke_config("flare_pde"), device="cpu", policy=policy)
    return jm, jparams, tm, load_jax_params(tm.init(seed), _np(jparams))


def _batches(n_steps, b=4, n=48, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.random((b, n, 3)).astype(np.float32),
             "y": rng.standard_normal((b, n, 1)).astype(np.float32)} for _ in range(n_steps)]


def _jax_tree_of(net):
    """The port's parameters as a flat {jax/path: array} dict."""
    return to_jax_flat(net.state_dict())


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --- autograd through the fused backend ------------------------------------


@pytest.mark.parametrize("shape", [(2, 4, 16, 97, 8), (3, 2, 20, 45, 4)])
def test_packed_autograd_matches_sdpa_autograd(shape):
    """The FlareFused function (plain forward and backward on the CPU) gives
    the gradients autograd finds through the plain sdpa mixer."""
    b, h, m, n, d = shape
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal(s) * 0.5).astype(np.float32)
              for s in ((h, m, d), (b, h, n, d), (b, h, n, d), (b, h, n, d))]
    grads = {}
    for backend in ("packed", "sdpa"):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
        y = tflare.flare_mixer(q, k, v, policy=MixerPolicy(backends=(backend,)))
        (y * torch.from_numpy(arrays[3])).sum().backward()
        grads[backend] = (y.detach(), q.grad, k.grad, v.grad)
    for got, want in zip(grads["packed"], grads["sdpa"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_model_loss_grads_through_packed_match_sdpa():
    """The surrogate's loss gradients under a packed train plan equal those
    under sdpa, on the same weights and batch; no kernel is launched on the
    CPU."""
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    grads = {}
    before = launch_counts()
    for backend in ("packed", "sdpa"):
        _, _, tm, net = _smoke_pair(policy=MixerPolicy(backends=(backend,)))
        assert tm.plans["train"].backend == backend
        tm.loss(net, batch).backward()
        grads[backend] = {k: p.grad for k, p in net.named_parameters()}
    assert launch_counts() == before
    for name, g in grads["packed"].items():
        torch.testing.assert_close(g, grads["sdpa"][name], atol=1e-5, rtol=1e-4, msg=name)


# --- optimizer and schedule -------------------------------------------------


@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 0.0), (1.0, 1e-2), (0.05, 1e-5)])
def test_adamw_update_matches_jax(grad_clip, weight_decay):
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp, jstate = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jinit_adamw(jp), init_adamw(tp)
    kw = dict(weight_decay=weight_decay, beta1=0.9, beta2=0.999, eps=1e-8, grad_clip=grad_clip)
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        lr = 1e-2 / (step + 1)
        jp, jstate, jnorm = jadamw_update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                                          jstate, lr=jnp.float32(lr), **kw)
        tp, tstate, tnorm = adamw_update(tp, {k: torch.from_numpy(g) for k, g in grads.items()},
                                         tstate, lr=lr, **kw)
        np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
            np.testing.assert_allclose(tstate.m[k].numpy(), np.asarray(jstate.m[k]), atol=1e-6)
            np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]), atol=1e-6)
    assert tstate.step == int(jstate.step) == 3


@pytest.mark.parametrize("total,warmup", [(100, 0.1), (7, 0.5), (1, 0.1)])
def test_onecycle_schedule_matches_jax(total, warmup):
    """atol 1e-9, 3e-7 of the peak: JAX takes the cosine in fp32, the port in
    fp64, which differ near the end of the decay."""
    for step in sorted({0, 1, total // 3, total // 2, total - 1, total, total + 5}):
        got = onecycle_schedule(step, total_steps=total, peak_lr=3e-3, warmup_frac=warmup)
        want = float(jonecycle(step, total_steps=total, peak_lr=3e-3, warmup_frac=warmup))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


# --- the train step against the JAX train step -----------------------------


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_train_step_matches_jax(num_microbatches):
    jm, jparams, tm, net = _smoke_pair()
    kw = dict(steps=10, learning_rate=3e-3, warmup_frac=0.2, weight_decay=1e-4, grad_clip=1.0)
    jstep = jax.jit(jmake_train_step(jm.loss, JTrainConfig(**kw),
                                     num_microbatches=num_microbatches))
    tstep = make_train_step(tm.loss, TrainConfig(**kw), num_microbatches=num_microbatches)
    jopt, topt = jinit_adamw(jparams), init_adamw(dict(net.named_parameters()))
    for batch in _batches(3):
        jparams, jopt, jmet = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        net, topt, tmet = tstep(net, topt, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    want = _flat_jax(jparams)
    got = _jax_tree_of(net)
    assert sorted(got) == sorted(want)
    for key, arr in got.items():
        np.testing.assert_allclose(arr, want[key], atol=1e-4, err_msg=key)
    assert all(p.grad is None for p in net.parameters())


def test_train_step_rejects_uneven_microbatches():
    _, _, tm, net = _smoke_pair()
    step = make_train_step(tm.loss, TrainConfig(steps=2), num_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(net, init_adamw(dict(net.named_parameters())),
             {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()})


def test_eval_step_matches_jax_loss():
    jm, jparams, tm, net = _smoke_pair()
    batch = _batches(1)[0]
    got = make_eval_step(tm.loss)(net, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(jm.loss(jparams, {k: jnp.asarray(v) for k, v
                                                                   in batch.items()})), atol=1e-5)


# --- checkpoints across the two packages -----------------------------------


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, jparams, tm, net = _smoke_pair(seed=3)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.25)    # differ from the JAX init, so the restore must carry them
    CheckpointManager(str(tmp_path), keep=2).save(7, _jax_tree_of(net), blocking=True)
    step, restored = JCheckpointManager(str(tmp_path)).restore_latest(jparams)
    assert step == 7
    want = _jax_tree_of(net)
    for key, arr in _flat_jax(restored).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)


def test_jax_checkpoint_restores_in_port(tmp_path):
    jm, jparams, tm, net = _smoke_pair(seed=4)
    jparams = jax.tree.map(lambda x: x * 1.5 + 0.125, jparams)
    JCheckpointManager(str(tmp_path)).save(11, jparams, blocking=True)
    cm = CheckpointManager(str(tmp_path))
    step, flat = cm.restore_latest()
    assert step == 11
    net.load_state_dict(from_jax_flat(flat), strict=True)
    want = _flat_jax(jparams)
    for key, arr in _jax_tree_of(net).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)


def test_checkpoint_keep_k_latest_and_corruption(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    leaves = {"a/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
              "a/bias": torch.ones(3, dtype=torch.bfloat16)}
    for step in (1, 2, 3):
        cm.save(step, leaves)
    cm.wait()
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    got = cm.restore(3)
    assert got["a/bias"].dtype == np.float32     # bf16 stored as its fp32 widening
    np.testing.assert_array_equal(got["a/kernel"], leaves["a/kernel"])
    path = tmp_path / "step_3" / "meta.json"
    meta = path.read_text().replace('"crc32": ', '"crc32": 1', 1)
    path.write_text(meta)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(3)


# --- the trainer (tests/test_trainer_serve.py on the PDE smoke config) -----


def _tcfg(ckdir, steps=20, **kw):
    return TrainConfig(steps=steps, learning_rate=3e-3, checkpoint_every=10,
                       checkpoint_dir=str(ckdir), log_every=100, **kw)


def _pde_batches(seed):
    data = _batches(16, b=4, n=40, seed=seed)
    return lambda step: data[step % len(data)]


def test_trainer_loss_decreases_and_resumes(tmp_path):
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "ck"))
    hist = tr.fit(_pde_batches(1))
    assert len(hist) == 20 and hist[-1]["loss"] < hist[0]["loss"]
    tr2 = Trainer(model, _tcfg(tmp_path / "ck"))
    assert tr2.step == 20 and tr2.opt_state.step == 20
    for (name, a), b in zip(tr.net.named_parameters(), tr2.net.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_trainer_restart_mid_run_is_deterministic(tmp_path):
    """20 steps straight against 10, a 'crash', and 10 resumed: the data is
    step-keyed and the parameters come from the checkpoint; the moments
    restart at zero, so the runs stay close rather than equal."""
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    batch_fn = _pde_batches(2)
    h_straight = Trainer(model, _tcfg(tmp_path / "a")).fit(batch_fn)
    Trainer(model, _tcfg(tmp_path / "b")).fit(batch_fn, steps=10)
    tr_b = Trainer(model, _tcfg(tmp_path / "b"))
    assert tr_b.step == 10
    h_resumed = tr_b.fit(batch_fn)
    assert [h["step"] for h in h_resumed] == list(range(11, 21))
    assert abs(h_straight[-1]["loss"] - h_resumed[-1]["loss"]) < 0.5


class _StepClock:
    """A stand-in for the trainer's ``time`` module: the clock moves only
    when the batch function advances it, so every step takes exactly what
    the test says, whatever the machine's load."""

    def __init__(self):
        self.now = 1000.0

    def time(self) -> float:
        return self.now


def test_trainer_straggler_watchdog_fires(tmp_path, monkeypatch):
    """Steps of a fixed 0.1 s on a fake clock, step 6 of 10 s: far more than
    twice the median, and no other step is."""
    import repro_torch.train.trainer as trainer_mod

    clock = _StepClock()
    monkeypatch.setattr(trainer_mod, "time", clock)
    events = []
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "wd", steps=8),
                 on_straggler=lambda s, dt, med: events.append((s, dt, med)),
                 straggler_factor=2.0)
    data = _pde_batches(3)

    def batch_fn(step):
        clock.now += 10.0 if step == 6 else 0.1    # inject a straggler
        return data(step)

    tr.fit(batch_fn)
    assert 6 in [step for step, _, _ in events], events   # the injected step is flagged
    assert tr.metrics.get("train.stragglers").value == len(events)


def test_trainer_straggler_watchdog_fires_real_time(tmp_path):
    """The same on the real clock: step 6 sleeps three times the slowest
    step before it (at least 1 s), so it exceeds twice the median of the
    last steps however slow the machine runs them (the median of steps 0-6
    is one of steps 0-5)."""
    import time as _time

    events = []
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "wd", steps=8),
                 on_straggler=lambda s, dt, med: events.append((s, dt, med)),
                 straggler_factor=2.0)
    data = _pde_batches(3)

    def batch_fn(step):
        if step == 6:
            _time.sleep(max(1.0, 3 * max(tr._step_times)))    # inject a straggler
        return data(step)

    tr.fit(batch_fn)
    assert 6 in [step for step, _, _ in events], events   # the injected step is flagged
    assert tr.metrics.get("train.stragglers").value == len(events)


def test_trainer_stop_flag_checkpoints(tmp_path):
    """The SIGTERM path: setting the stop flag mid-run leaves a final blocking
    checkpoint at the interrupted step."""
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "ck", steps=100))
    data = _pde_batches(4)

    def batch_fn(step):
        if step == 5:
            tr._stop = True     # what the signal handler does
        return data(step)

    tr.fit(batch_fn)
    assert tr.ckpt.latest_step() == tr.step == 6


def test_trainer_signal_handlers_last_for_fit_alone(tmp_path, monkeypatch):
    """``fit`` handles SIGTERM/SIGINT while it runs and restores the previous
    handlers after; a handler installed outside Python (``getsignal`` gives
    None) could not be restored, so ``fit`` leaves that signal alone."""
    import signal

    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    sigs = (signal.SIGTERM, signal.SIGINT)
    before = [signal.getsignal(s) for s in sigs]
    seen = []
    data = _pde_batches(6)

    def batch_fn(step):
        seen.append([signal.getsignal(s) for s in sigs])
        return data(step)

    tr = Trainer(model, _tcfg(tmp_path / "a", steps=2))
    tr.fit(batch_fn)
    assert seen[0] == [tr._handle_term] * 2
    assert [signal.getsignal(s) for s in sigs] == before

    real_getsignal, real_signal, installed = signal.getsignal, signal.signal, []
    monkeypatch.setattr(signal, "getsignal",
                        lambda s: None if s == signal.SIGTERM else real_getsignal(s))
    monkeypatch.setattr(signal, "signal", lambda s, h: installed.append(s) or real_signal(s, h))
    Trainer(model, _tcfg(tmp_path / "b", steps=2)).fit(batch_fn)
    assert installed == [signal.SIGINT, signal.SIGINT]   # installed, then restored
    assert real_getsignal(signal.SIGINT) == before[1]


def test_trainer_full_state_restores_in_jax_layout(tmp_path):
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "ck", steps=3))
    tr.fit(_pde_batches(5))
    tr.save_full_state()
    flat = tr.ckpt.restore(3)
    params = {k for k in flat if k.startswith("params/")}
    assert params and {k.split("/", 1)[0] for k in flat} == {"params", "m", "v"}
    assert len(params) == len([k for k in flat if k.startswith("m/")])
    jm = jget_model(jconfigs.get_smoke_config("flare_pde"))
    template = {"params": jm.init(jax.random.PRNGKey(0))}
    template["m"] = template["v"] = template["params"]
    restored = JCheckpointManager(str(tmp_path / "ck")).restore(3, template)
    for key, arr in _jax_tree_of(tr.net).items():
        np.testing.assert_array_equal(np.asarray(_flat_jax(restored["params"])[key]), arr)


def test_trainer_metrics_and_trace(tmp_path):
    from repro_torch.obs import Tracer

    tracer = Tracer()
    model = get_model(get_smoke_config("flare_pde"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "ck", steps=12), tracer=tracer)
    hist = tr.fit(_pde_batches(6))
    snap = tr.metrics.snapshot()
    assert snap["train.steps"] == 12 and snap["train.checkpoints"] == 1
    assert snap["train.step_s"]["count"] == 12
    names = [e.name for e in tracer.events]
    assert names.count("train_step") == 12 and names.count("checkpoint") == 1
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "step", "time"}
    n = tracer.write(str(tmp_path / "trace.json"))
    assert n == 13
