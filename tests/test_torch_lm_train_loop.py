"""Training the port's LMs against the JAX package, the loop around the
loss (split from ``tests/test_torch_lm_train.py``, whose helpers it uses):
the train step, the trainer on ``TokenStream``, checkpoints in the stacked
layout across the two packages and the launcher.

Inputs are drawn with numpy from a seed and given to both packages; weights
are carried from the JAX tree (``interop``). Tolerances: the loss 1e-5
relative in fp32 compute, the grad norm 1e-4, the parameters after one
train step 1e-5; checkpoints bit for bit."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import get_model as jget_model
from repro.optim.adamw import init_adamw as jinit_adamw
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.interop import from_jax_flat, jax_keys, params_from_jax, to_jax_flat, unstack_layers
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.api import get_model
from repro_torch.optim import init_adamw
from repro_torch.train import Trainer, make_train_step
from test_torch_lm_train import _batch, _j, _np, _pair, _t


# --- the train step and the trainer --------------------------------------------


@pytest.mark.parametrize("num_microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["flare_lm", "qwen2_1_5b"])
def test_train_step_matches_jax(arch, num_microbatches):
    """One step from an optimizer at step 1 (the schedule's lr is 0 at step
    0): loss, grad_norm and every parameter after it. Adam divides each
    gradient by its own RMS, so a gradient of 1e-7 whose last bits differ
    moves its parameter by a different fraction of lr (0.016 of it at most
    here); a peak lr of 3e-4 keeps that within the 1e-5."""
    _, jm, jp, _, tm, net = _pair(arch)
    kw = dict(steps=10, learning_rate=3e-4, warmup_frac=0.1, weight_decay=1e-4, grad_clip=1.0)
    jstep = jax.jit(jmake_train_step(jm.loss, JTrainConfig(**kw),
                                     num_microbatches=num_microbatches))
    tstep = make_train_step(tm.loss, TrainConfig(**kw), num_microbatches=num_microbatches)
    jopt = jinit_adamw(jp)
    jopt = jopt._replace(step=jnp.asarray(1, jopt.step.dtype))
    topt = init_adamw(dict(net.named_parameters()))
    topt.step = 1
    batch = _batch(b=4, s=16)
    jp, _, jmet = jstep(jp, jopt, _j(batch))
    net, topt, tmet = tstep(net, topt, _t(batch))
    assert math.isclose(float(tmet["loss"]), float(jmet["loss"]), rel_tol=1e-5)
    assert math.isclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rel_tol=1e-4)
    assert tmet["lr"] > 0
    want = params_from_jax(unstack_layers(_np(jp)))
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=1e-5, rtol=1e-5, msg=name)


def _tcfg(ckdir, steps=6):
    return TrainConfig(steps=steps, learning_rate=3e-3, checkpoint_every=3,
                       checkpoint_dir=str(ckdir), log_every=100)


def test_trainer_fits_token_stream_and_resumes(tmp_path):
    """Trainer.fit on TokenStream batches (int32 numpy) with two microbatches:
    finite losses that fall, no kernel launched, checkpoints in the stacked
    layout that a second trainer restores."""
    model = get_model(get_smoke_config("flare_lm"), device="cpu")
    stream = TokenStream(128, 32, seed=0)
    before = launch_counts()
    tr = Trainer(model, _tcfg(tmp_path / "ck", steps=8), num_microbatches=2)
    hist = tr.fit(lambda step: stream.global_batch(step % 2, 4, 1))
    assert launch_counts() == before
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    flat = tr.ckpt.restore(8)
    assert flat["layers/attn/q_latent"].shape[0] == 2 and "layers/0/norm1/scale" not in flat
    assert sorted(flat) == sorted(jax_keys(tr.net.state_dict()))
    tr2 = Trainer(model, _tcfg(tmp_path / "ck", steps=8))
    assert tr2.step == 8
    for (name, a), b in zip(tr.net.named_parameters(), tr2.net.parameters()):
        assert torch.equal(a, b), name


# --- checkpoints: the stacked layout across the two packages --------------------


@pytest.mark.parametrize("arch", ["flare_lm", "qwen2_1_5b"])
def test_lm_checkpoints_cross_packages(arch, tmp_path):
    """A port checkpoint restores in JAX with stacked ``layers`` leaves (one
    [L, ...] leaf each), and a JAX checkpoint restores in the port."""
    _, jm, jp, _, tm, net = _pair(arch)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.25)
    CheckpointManager(str(tmp_path / "a")).save(5, to_jax_flat(net.state_dict()),
                                                blocking=True)
    step, restored = JCheckpointManager(str(tmp_path / "a")).restore_latest(jp)
    assert step == 5
    got = params_from_jax(unstack_layers(_np(restored)))
    for name, p in net.state_dict().items():
        assert torch.equal(got[name], p), name
    jp2 = jax.tree.map(lambda x: x * 1.5 + 0.125, jp)
    JCheckpointManager(str(tmp_path / "b")).save(9, jp2, blocking=True)
    step, flat = CheckpointManager(str(tmp_path / "b")).restore_latest()
    assert step == 9 and flat["layers/norm1/scale"].shape[0] == 2
    net.load_state_dict(from_jax_flat(flat), strict=True)
    want = params_from_jax(unstack_layers(_np(jp2)))
    for name, p in net.state_dict().items():
        assert torch.equal(p, want[name]), name


def test_full_state_restores_in_jax(tmp_path):
    """save_full_state's parameters and moments of an LM restore in JAX
    under the stacked template."""
    model = get_model(get_smoke_config("qwen2_1_5b"), device="cpu")
    tr = Trainer(model, _tcfg(tmp_path / "ck", steps=2))
    tr.fit(lambda step: TokenStream(128, 16, seed=1).global_batch(step, 2, 1))
    tr.save_full_state()
    jp = jget_model(jget_smoke("qwen2_1_5b")).init(jax.random.PRNGKey(0))
    restored = JCheckpointManager(str(tmp_path / "ck")).restore(2, {"params": jp, "m": jp,
                                                                    "v": jp})
    for prefix, tensors in (("params", tr.net.state_dict()), ("m", tr.opt_state.m),
                            ("v", tr.opt_state.v)):
        got = params_from_jax(unstack_layers(_np(restored[prefix])))
        for name, t in tensors.items():
            assert torch.equal(got[name], t), (prefix, name)


def test_interop_keeps_per_layer_paths():
    """from_jax_flat splits a stacked leaf and passes per-layer paths
    (``layers/0/...``, the unstacked tree's) through; to_jax_flat stacks."""
    sd = {"layers.0.mlp.w_up.weight": torch.randn(3, 2), "layers.1.mlp.w_up.weight":
          torch.randn(3, 2), "embed.table": torch.randn(4, 2)}
    flat = to_jax_flat(sd)
    assert sorted(flat) == ["embed/table", "layers/mlp/w_up/kernel"]
    assert flat["layers/mlp/w_up/kernel"].shape == (2, 2, 3)
    back = from_jax_flat(flat)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    per_layer = from_jax_flat({"layers/0/mlp/w_up/kernel": np.ones((2, 3), np.float32)})
    assert per_layer["layers.0.mlp.w_up.weight"].shape == (3, 2)


# --- the launcher ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["flare_lm", "qwen2_1_5b"])
def test_launcher_trains_lm(arch, tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
          "--global-batch", "4", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "mixer plans" in out and f"3 steps, loss" in out
    first, last = (float(x) for x in out.rsplit("loss ", 1)[1].split("->"))
    assert math.isfinite(first) and math.isfinite(last)
