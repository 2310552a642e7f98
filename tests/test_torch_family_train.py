"""The training loop of the encoder-decoder (seamless-m4t-large-v2, both
encoders), RWKV-6 and Zamba2 in the port against the JAX package: one train
step, checkpoints across the two packages and the launcher (the loop that
``tests/test_torch_lm_train_loop.py`` holds for ``flare_lm`` and the dense
family).

The smoke configs are drawn by the JAX package, their zero-initialised
leaves given random values (``test_torch_rwkv.perturb``) so that every term
reaches the loss, and carried into the port with ``interop``. Batches are
``TokenStream`` tokens and labels, and for the encoder-decoder standard
normal source frames, drawn with numpy. Tolerances as for the LMs: the loss
1e-5 relative in fp32 compute, the grad norm 1e-4, every parameter after
one step 1e-5; checkpoints bit for bit. The step runs two microbatches, so
that the gradients' accumulation is held too."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import seamless_m4t_large_v2 as jseamless
from repro.models.api import get_model as jget_model
from repro.optim.adamw import init_adamw as jinit_adamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, replace
from repro_torch.configs import get_smoke_config
from repro_torch.configs import seamless_m4t_large_v2 as tseamless
from repro_torch.data.synthetic import TokenStream
from repro_torch.interop import from_jax_flat, load_jax_params, params_from_jax, to_jax_flat, unstack_layers
from repro_torch.models.api import get_model
from repro_torch.optim import init_adamw
from repro_torch.train import make_train_step

from test_torch_rwkv import perturb

# case -> (the launcher's --arch, the JAX smoke config, the port's)
CASES = {
    "seamless_attn": ("seamless_m4t_large_v2", lambda: jseamless.smoke_config("attn"),
                      lambda: tseamless.smoke_config("attn")),
    "seamless_flare": ("seamless_m4t_large_v2", lambda: jseamless.smoke_config("flare"),
                       lambda: tseamless.smoke_config("flare")),
    "rwkv6_3b": ("rwkv6_3b", lambda: jget_smoke("rwkv6_3b"),
                 lambda: get_smoke_config("rwkv6_3b")),
    "zamba2_7b": ("zamba2_7b", lambda: jget_smoke("zamba2_7b"),
                  lambda: get_smoke_config("zamba2_7b")),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX model in fp32 compute and its (perturbed) params, numpy."""
    _, jcfg, _ = CASES[case]
    jm = jget_model(dataclasses.replace(jcfg(), compute_dtype="float32"))
    return jm, perturb(_np(jm.init(jax.random.PRNGKey(0))), seed=1)


def _pair(case):
    """(JAX model, JAX params, port model, port net) in fp32 compute on the
    same weights; the port's net drawn anew each call."""
    jm, jp = _jax(case)
    tm = get_model(replace(CASES[case][2](), compute_dtype="float32"), device="cpu")
    net = load_jax_params(tm.init(0), unstack_layers(jp))
    return jm, jax.tree.map(jnp.asarray, jp), tm, net


def _batch(cfg, b=4, s=16, seed=3):
    """The launcher's batch: TokenStream tokens and labels (int32), and for
    the encoder-decoder standard normal frames [b, s, d_model] fp32."""
    batch = TokenStream(cfg.vocab, s, seed=seed).global_batch(seed, b, 1)
    if cfg.family in ("encdec", "audio"):
        batch["embeds"] = np.random.default_rng(seed).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    """One step of two microbatches from an optimizer at step 1 (the
    schedule's lr is 0 at step 0): the loss, the grad norm and every
    parameter after it. Adam's first step moves a parameter by lr g / (|g| +
    eps), so where |g| is near eps a gradient's fp32 rounding moves the
    step: Zamba2's ``shared.lora_k.a`` has an element of 8.3e-8 whose
    gradient the two packages give 4e-8 apart (2.5e-6 of the leaf's max |g|),
    about 4% of lr; a peak lr of 1e-4 keeps that within the 1e-5, and every
    other parameter still moves by up to 10x the limit."""
    jm, jp, tm, net = _pair(case)
    kw = dict(steps=10, learning_rate=1e-4, warmup_frac=0.1, weight_decay=1e-4, grad_clip=1.0)
    jstep = jax.jit(jmake_train_step(jm.loss, JTrainConfig(**kw), num_microbatches=2))
    tstep = make_train_step(tm.loss, TrainConfig(**kw), num_microbatches=2)
    jopt = jinit_adamw(jp)
    jopt = jopt._replace(step=jnp.asarray(1, jopt.step.dtype))
    topt = init_adamw(dict(net.named_parameters()))
    topt.step = 1
    batch = _batch(tm.cfg)
    jp, _, jmet = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    net, topt, tmet = tstep(net, topt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert math.isclose(float(tmet["loss"]), float(jmet["loss"]), rel_tol=1e-5)
    assert math.isclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rel_tol=1e-4)
    assert tmet["lr"] > 0
    want = params_from_jax(unstack_layers(_np(jp)))
    assert sorted(want) == sorted(dict(net.named_parameters()))
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoints_cross_packages(case, tmp_path):
    """A port checkpoint restores in JAX under the JAX tree's template, and
    a JAX checkpoint restores in the port, every leaf bit for bit."""
    _, jp, _, net = _pair(case)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.25)
    CheckpointManager(str(tmp_path / "a")).save(5, to_jax_flat(net.state_dict()),
                                                blocking=True)
    step, restored = JCheckpointManager(str(tmp_path / "a")).restore_latest(jp)
    assert step == 5
    got = params_from_jax(unstack_layers(_np(restored)))
    assert sorted(got) == sorted(net.state_dict())
    for name, p in net.state_dict().items():
        assert torch.equal(got[name], p), name
    jp2 = jax.tree.map(lambda x: x * 1.5 + 0.125, jp)
    JCheckpointManager(str(tmp_path / "b")).save(9, jp2, blocking=True)
    step, flat = CheckpointManager(str(tmp_path / "b")).restore_latest()
    assert step == 9
    net.load_state_dict(from_jax_flat(flat), strict=True)
    want = params_from_jax(unstack_layers(_np(jp2)))
    for name, p in net.state_dict().items():
        assert torch.equal(p, want[name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_launcher_trains(case, tmp_path, capsys, monkeypatch):
    """The launcher trains the smoke config 3 steps on its own batches (the
    FLARE encoder's case through the same ``--arch``, its smoke config
    swapped in) and prints finite losses."""
    from repro_torch.launch import train

    arch, _, tcfg = CASES[case]
    monkeypatch.setattr(train, "get_smoke_config", lambda name: tcfg())
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
                "--global-batch", "4", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert f"{tcfg().name}: 3 steps, loss" in out
    first, last = (float(x) for x in out.rsplit("loss ", 1)[1].split("->"))
    assert math.isfinite(first) and math.isfinite(last)
    if case == "seamless_flare":
        assert "mixer plans (resolved once at build): infer=sdpa train=sdpa" in out
