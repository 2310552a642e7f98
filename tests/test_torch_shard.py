"""The port's sequence-parallel FLARE path against the JAX package.

The port runs one process a rank: each test starts its ranks as Python
subprocesses in a gloo group (a ``file://`` rendezvous in the test's own
temporary directory, so groups of parallel test workers never meet), and
each rank saves its local results. The JAX side runs on 4 virtual CPU
devices through ``conftest.run_in_cpu_mesh`` (Pallas in interpret mode), on
the same numpy-seeded inputs. The reference test's shapes
(``tests/test_mesh_parallel.py``): mesh (2, 2) at B=2, H=4, N=96, M=5, D=8
and mesh (4,) at N=128, M=6.

Limits: y 1e-5 absolute, gradients 1e-4 of their largest magnitude (the
JAX mesh tests' own). A rank's gradient of a replicated input is its part;
the parts of all the ranks holding a replica are summed before the
comparison, as the trainer's all-reduce sums them. The sharded train step
at world sizes 1, 2 and 4 is held against the single-process step at 1e-5
(losses, gradient norms and parameters after 2 AdamW steps).
"""
import inspect
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_in_cpu_mesh
from repro_torch.core.dispatch import (
    MixerShape,
    eligible,
    get_backend,
    resolve,
    sharded_plan,
)
from repro_torch.core.policy import MixerPolicy, resolve_policy

REPO = Path(__file__).resolve().parents[1]
Y_TOL, GRAD_TOL, TRAIN_TOL = 1e-5, 1e-4, 1e-5

# name: (mesh shape, axes, B, H, N, M, D, seed)
CASES = {
    "packed_shard_2x2": ((2, 2), ("data", "model"), 2, 4, 96, 5, 8, 0),
    "packed_shard_4": ((4,), ("data",), 2, 4, 128, 6, 8, 1),
    "seqparallel_4": ((4,), ("data",), 2, 4, 128, 6, 8, 1),
    "seqlat_2x2": ((2, 2), ("data", "model"), 2, 4, 96, 6, 8, 2),
}



def inputs(B, H, N, M, D, seed):
    """q [H, M, D], k, v [B, H, N, D] from numpy's generator: the same values
    in this process, the JAX subprocess and every rank."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((H, M, D), (B, H, N, D), (B, H, N, D)))


INPUTS = "import numpy as np\n" + inspect.getsource(inputs)

JAX_CODE = INPUTS + r"""
import jax, jax.numpy as jnp
from repro.core.dispatch import MixerPlan, get_backend
from repro.distributed.compat import make_mesh
from repro.kernels.flare_packed_shard import flare_mixer_packed_shard

CASES = %r
meshes = {}
out = {}
for name, (shape, axes, B, H, N, M, D, seed) in CASES.items():
    mesh = meshes.setdefault(shape, make_mesh(shape, axes))
    if name.startswith("packed_shard"):
        lat = ("model",) if "model" in axes else ()
        fn = lambda q, k, v, mesh=mesh, lat=lat: flare_mixer_packed_shard(
            q, k, v, mesh=mesh, seq_axes=("data",), lat_axes=lat, block_n=32)
    elif name.startswith("seqparallel"):
        plan = MixerPlan("seqparallel", {"mesh": mesh, "seq_axes": "data"})
        fn = lambda q, k, v, plan=plan: get_backend("seqparallel").run(plan, q, k, v)
    else:
        plan = MixerPlan("seqlat", {"mesh": mesh, "seq_axes": "data", "lat_axes": "model"})
        fn = lambda q, k, v, plan=plan: get_backend("seqlat").run(plan, q, k, v)
    q, k, v = map(jnp.asarray, inputs(B, H, N, M, D, seed))
    out[name + "/y"] = np.asarray(fn(q, k, v))
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v))), argnums=(0, 1, 2))(q, k, v)
    for g, which in zip(grads, ("dq", "dk", "dv")):
        out[name + "/" + which] = np.asarray(g)
np.savez(%r, **out)
print("PASS")
"""

# each rank: its slices of the global inputs, the mixer on them, sum(sin(y))
# backpropagated (over the latent ranks, which share y, a mean), its local
# results saved with the slices they cover
TORCH_MIXERS = INPUTS + r"""
import os, torch
from repro_torch.core.flare_sp import flare_mixer_seqlat, flare_mixer_seqparallel
from repro_torch.distributed.compat import (all_gather, axis_group, group_rank, group_size,
                                            init, make_mesh)
from repro_torch.kernels.flare_packed_shard import flare_mixer_packed_shard

CASES = %r
rank = int(os.environ["RANK"])
init("cpu", init_method=os.environ["INIT"])
out = {}
for name, (shape, axes, B, H, N, M, D, seed) in CASES.items():
    mesh = make_mesh(shape, axes, device_type="cpu")
    seq = axis_group(mesh, "data")
    lat = axis_group(mesh, "model") if "model" in axes else None
    q, k, v = (torch.from_numpy(a) for a in inputs(B, H, N, M, D, seed))
    ns = N // group_size(seq)
    n0 = group_rank(seq) * ns
    h0, hs, m0, ms = 0, H, 0, M
    if name.startswith("packed_shard") and lat is not None:
        hs = H // group_size(lat)
        h0 = group_rank(lat) * hs
    if name.startswith("seqlat"):
        ms = M // group_size(lat)
        m0 = group_rank(lat) * ms
    ql = q[h0:h0 + hs, m0:m0 + ms].clone().requires_grad_(True)
    kl, vl = (t[:, h0:h0 + hs, n0:n0 + ns].clone().requires_grad_(True) for t in (k, v))
    if name.startswith("packed_shard"):
        y = flare_mixer_packed_shard(ql, kl, vl, mesh=mesh, seq_axes=("data",),
                                     lat_axes=("model",) if lat is not None else ())
        share = 1
    elif name.startswith("seqparallel"):
        y, share = flare_mixer_seqparallel(ql, kl, vl, group=seq), 1
    else:
        y = flare_mixer_seqlat(ql, kl, vl, seq_group=seq, lat_group=lat)
        share = group_size(lat)
    (torch.sin(y).sum() / share).backward()
    out[name] = dict(y=y.detach(), dq=ql.grad, dk=kl.grad, dv=vl.grad,
                     h=(h0, h0 + hs), m=(m0, m0 + ms), n=(n0, n0 + ns))
# the differentiable gather: slot r holds rank r's tensor, and each rank's
# gradient sums its slot's gradient over the ranks
world = axis_group(make_mesh((4,), ("data",), device_type="cpu"), "data")
x = torch.full((3,), float(rank), requires_grad=True)
g = all_gather(x * 2, world)
(g * torch.arange(1.0, 5.0)[:, None]).sum().backward()
out["gather"] = dict(value=g.detach(), grad=x.grad)
torch.save(out, os.environ["OUT"])
"""

TORCH_TRAIN = r"""
import os, torch
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import MixerPolicy
from repro_torch.data.pde_data import darcy_batch
from repro_torch.distributed.compat import COUNTS, init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import get_model
from repro_torch.train import Trainer

init("cpu", init_method=os.environ["INIT"])
mesh = make_host_mesh(device_type="cpu")
cfg = get_smoke_config("flare_pde")
model = get_model(cfg, policy=MixerPolicy(backends=(os.environ["BACKEND"],)), device="cpu",
                  mesh=mesh, seq_len_hint=256)
tcfg = TrainConfig(steps=2, learning_rate=1e-3, seed=0, checkpoint_every=1,
                   checkpoint_dir=os.environ["CKPT"], log_every=1)
trainer = Trainer(model, tcfg, mesh)
history = trainer.fit(lambda step: darcy_batch(0, step, 4, grid=16, cg_iters=100, device="cpu"))
torch.save(dict(loss=[h["loss"] for h in history], grad_norm=[h["grad_norm"] for h in history],
                params={k: p.detach() for k, p in trainer.net.named_parameters()},
                plan=model.plans["train"].describe(), collectives=dict(COUNTS),
                steps=trainer.ckpt.all_steps()),
           os.environ["OUT"])
"""


def run_ranks(code: str, world: int, tmp: Path, timeout: int = 240, **env) -> list:
    """Run ``code`` as ``world`` ranks of one gloo group; return each rank's
    saved results (the code saves them to ``$OUT``)."""
    base = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE=str(world),
                INIT=f"file://{tmp / 'rendezvous'}", OMP_NUM_THREADS="1", **env)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(base, RANK=str(r), OUT=str(tmp / f"rank{r}.pt")))
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def mixer_runs(tmp_path_factory):
    """The JAX package on each case (a subprocess each) and the port's 4 ranks
    on all of them, run at the same time: (JAX outputs, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("mixers")
    with ThreadPoolExecutor(len(CASES) + 1) as pool:
        port = pool.submit(run_ranks, TORCH_MIXERS % (CASES,), 4, tmp)
        for name in CASES:
            pool.submit(run_in_cpu_mesh, JAX_CODE % ({name: CASES[name]}, str(tmp / name)))
    ref = {}
    for name in CASES:
        ref.update(np.load(tmp / f"{name}.npz"))
    return ref, port.result()


@pytest.fixture(scope="module")
def jax_ref(mixer_runs):
    return mixer_runs[0]


@pytest.fixture(scope="module")
def port_ranks(mixer_runs):
    return mixer_runs[1]


def _assemble(ranks, name, what, shape):
    """The global tensor from the ranks' parts: y placed (replicas must
    agree), gradients summed over the ranks holding a replica."""
    out = np.zeros(shape)
    seen = np.zeros(shape, dtype=bool)
    for r in ranks:
        res = r[name]
        part = res[what].double().numpy()
        if what == "dq":
            idx = (slice(*res["h"]), slice(*res["m"]))
        else:
            idx = (slice(None), slice(*res["h"]), slice(*res["n"]))
        if what == "y":
            if seen[idx].any():
                np.testing.assert_array_equal(out[idx], part)
            out[idx] = part
        else:
            out[idx] += part
        seen[idx] = True
    assert seen.all(), f"{name} {what}: the ranks do not cover the tensor"
    return out


@pytest.mark.parametrize("what", ["y", "dq", "dk", "dv"])
@pytest.mark.parametrize("name", list(CASES))
def test_mixer_matches_jax_on_4_ranks(jax_ref, port_ranks, name, what):
    want = jax_ref[f"{name}/{what}"].astype(np.float64)
    got = _assemble(port_ranks, name, what, want.shape)
    err = np.abs(got - want).max()
    if what == "y":
        assert err <= Y_TOL, err
    else:
        assert err <= GRAD_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_all_gather_and_its_gradient(port_ranks):
    for r, res in enumerate(port_ranks):
        g = res["gather"]
        torch.testing.assert_close(g["value"], 2 * torch.arange(4.0)[:, None].expand(4, 3))
        # every rank's output weights slot r by r + 1, and 4 ranks hold one
        torch.testing.assert_close(g["grad"], torch.full((3,), 2.0 * 4 * (r + 1)))


@pytest.fixture(scope="module")
def single_process_run(tmp_path_factory):
    """The port's single-process step on the same model, seed and batches."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pde_data import darcy_batch
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer

    model = get_model(get_smoke_config("flare_pde"), policy=MixerPolicy(backends=("packed",)),
                      device="cpu")
    tcfg = TrainConfig(steps=2, learning_rate=1e-3, seed=0, checkpoint_every=1,
                       checkpoint_dir=str(tmp_path_factory.mktemp("ckpt1")), log_every=1)
    trainer = Trainer(model, tcfg)
    history = trainer.fit(lambda step: darcy_batch(0, step, 4, grid=16, cg_iters=100, device="cpu"))
    return dict(loss=[h["loss"] for h in history], grad_norm=[h["grad_norm"] for h in history],
                params={k: p.detach() for k, p in trainer.net.named_parameters()})


@pytest.mark.parametrize("backend,world", [("packed_shard", 1), ("packed_shard", 2),
                                           ("packed_shard", 4), ("seqparallel", 4)])
def test_sharded_train_step_matches_single_process(single_process_run, tmp_path, backend,
                                                   world):
    ranks = run_ranks(TORCH_TRAIN, world, tmp_path, BACKEND=backend, CKPT=str(tmp_path / "ck"))
    ref = single_process_run
    for r, res in enumerate(ranks):
        assert res["plan"].startswith(backend), res["plan"]
        if backend == "packed_shard":
            assert res["plan"].endswith(f"mesh_shape=data{world}xmodel1)"), res["plan"]
        np.testing.assert_allclose(res["loss"], ref["loss"], rtol=0, atol=TRAIN_TOL)
        # the norm before the clip: a gradient counted on every rank would be
        # W times the single process's (Adam and the clip would hide it in
        # the parameters)
        np.testing.assert_allclose(res["grad_norm"], ref["grad_norm"], rtol=TRAIN_TOL)
        for key, p in ref["params"].items():
            err = (res["params"][key] - p).abs().max().item()
            assert err <= TRAIN_TOL, (r, key, err)
        # every step all-reduces: the blocks' statistics and dZ, the loss's
        # sums and one flat gradient buffer
        assert res["collectives"]["calls"] > 0
    # rank 0 wrote the checkpoints of both steps
    assert ranks[0]["steps"] == [1, 2]


# --------------------------------------------------------------------------
# the registry, in process: eligibility reads the mesh's axes and sizes only
# --------------------------------------------------------------------------


class _Mesh:
    """What the registry reads of a DeviceMesh: its axis names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, dim):
        return self.shape[dim]


SHAPE = MixerShape(batch=4, heads=4, tokens=64, latents=8, head_dim=8)
F32 = torch.float32


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_mesh_symmetry(device):
    mesh = _Mesh((4, 1), ("data", "model"))
    for name in ("sdpa", "materialized", "packed", "pallas", "paged", "packed_shard",
                 "seqparallel", "seqlat", "causal_stream", "causal_pallas"):
        b = get_backend(name)
        causal = b.caps.causal
        with_mesh = eligible(b, dtype=F32, device=device, causal=causal, mesh=mesh)
        without = eligible(b, dtype=F32, device=device, causal=causal)
        assert not (with_mesh and not b.caps.sharded), name
        assert not (without and b.caps.sharded), name
    for grad in (False, True):
        backend, _ = resolve("auto", shape=SHAPE, dtype=F32, device=device, grad=grad)
        assert not backend.caps.sharded
    backend, plan = resolve("auto", shape=SHAPE, dtype=F32, device=device, grad=True,
                            mesh=mesh)
    assert backend.name == {"cuda": "packed_shard", "cpu": "seqparallel"}[device]
    assert plan.params["mesh"] is mesh
    with pytest.raises(ValueError, match="not sharded"):
        resolve("packed", shape=SHAPE, dtype=F32, device=device, mesh=mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        resolve("packed_shard", shape=SHAPE, dtype=F32, device=device)


def test_build_shard_plan_rejects_indivisible_shapes():
    """The plan rejects heads the latent axes do not divide. N is the batch's
    to split: a plan sees only a hint of it, so a hint that the token axes
    do not divide leaves the kernel form in place, and the rank's slice of
    the real N raises (``token_slice``)."""
    from repro_torch.backends.packed_shard import build_shard_plan
    from repro_torch.distributed.sharding import token_slice

    mesh = _Mesh((4,), ("data",))
    plan = build_shard_plan(SHAPE, mesh, ("data",), (), F32)
    assert plan.describe() == ("packed_shard(seq_axes=data;lat_axes=;block_n=16;block_m=256;"
                               "mesh_shape=data4)")
    with pytest.raises(ValueError, match="H=3"):
        build_shard_plan(MixerShape(2, 3, 64, 6, 8), _Mesh((2, 2), ("data", "model")),
                         ("data",), ("model",), F32)
    hint = MixerShape(2, 4, 63, 6, 8)
    assert build_shard_plan(hint, mesh, ("data",), (), F32).backend == "packed_shard"
    backend, _ = resolve("auto", shape=hint, dtype=F32, device="cuda", grad=True, mesh=mesh)
    assert backend.name == "packed_shard"
    with pytest.raises(ValueError, match="N=63 tokens do not split"):
        token_slice(63, mesh)
    # the latent axes that do not divide H: auto falls through to the plain form
    backend, _ = resolve("auto", shape=MixerShape(2, 3, 64, 6, 8), dtype=F32, device="cuda",
                         grad=True, mesh=_Mesh((2, 2), ("data", "model")))
    assert backend.name == "seqparallel"


@pytest.mark.parametrize("policy", [None, MixerPolicy(backends=("packed_shard",))])
def test_model_plans_on_a_mesh_the_token_hint_does_not_divide(policy):
    """pde_40k on 5 data ranks: 40,000 tokens split, the default hint (4096)
    does not. The model's plans on the card are the kernel form all the same."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import DEFAULT_TOKENS_HINT, _resolve_plans

    mesh = _Mesh((5, 1), ("data", "model"))
    assert DEFAULT_TOKENS_HINT % 5 and not 40000 % 5
    plans, train_error = _resolve_plans(get_config("flare_pde"), policy, torch.device("cuda"),
                                        None, mesh)
    assert train_error is None
    assert {key: p.backend for key, p in plans.items()} == {"infer": "packed_shard",
                                                            "train": "packed_shard"}


def test_sharded_plan_and_policy_axes():
    mesh = _Mesh((2, 2), ("data", "model"))
    assert sharded_plan(mesh, ("data", "model"), "model").backend == "seqparallel"
    assert sharded_plan(mesh, "data", "model").backend == "seqlat"
    assert sharded_plan(mesh, "data", "model", shape=SHAPE).backend == "packed_shard"
    assert sharded_plan(mesh, "data", "model", shape=SHAPE, device="cpu").backend == "seqlat"
    pol = MixerPolicy(seq_axes="data", lat_axes="model", requires_grad=True)
    assert resolve_policy(pol, SHAPE, mesh=mesh).backend == "packed_shard"
    with pytest.raises(ValueError, match="axis hints resolve to 'seqlat'"):
        resolve_policy(pol.with_(backends=("seqparallel",)), SHAPE, mesh=mesh, device="cpu")


def test_head_dim_gate():
    """On the card "auto" passes over a kernel backend at a D its kernel does
    not take, and naming it raises at resolve time; the CPU runs the plain
    versions at any D."""
    for d, want in ((8, "packed"), (64, "packed"), (65, "sdpa"), (128, "sdpa")):
        shape = MixerShape(batch=8, heads=4, tokens=4096, latents=64, head_dim=d)
        assert resolve("auto", shape=shape, dtype=F32, device="cuda", grad=True)[0].name == want
    wide = MixerShape(batch=8, heads=4, tokens=4096, latents=64, head_dim=65)
    for name in ("packed", "pallas"):
        with pytest.raises(ValueError, match="D=65"):
            resolve(name, shape=wide, dtype=F32, device="cuda")
        assert resolve(name, shape=wide, dtype=F32, device="cpu")[1].backend == name
    with pytest.raises(ValueError, match="D=65"):
        resolve("packed_shard", shape=wide, dtype=F32, device="cuda", mesh=_Mesh((2,), ("data",)))
    assert resolve("auto", shape=wide, dtype=F32, device="cuda", grad=True,
                   mesh=_Mesh((2,), ("data",)))[0].name == "seqparallel"
    # the causal kernel takes every D from 1 to 128 (at padded widths)
    for d, want in ((8, "causal_pallas"), (24, "causal_pallas"), (96, "causal_pallas"),
                    (128, "causal_pallas"), (129, "causal_stream")):
        shape = MixerShape(batch=1, heads=16, tokens=4096, latents=64, head_dim=d)
        assert resolve("auto", shape=shape, dtype=F32, device="cuda", causal=True)[0].name == want
    with pytest.raises(ValueError, match="D=129"):
        resolve("causal_pallas", shape=MixerShape(1, 16, 4096, 64, 129), dtype=F32,
                device="cuda", causal=True)
    # phi3's decode read (one latent, D=96); the paged kernel's MLA instance
    # takes D 129-512 (DeepSeek-V2-Lite's latent read: D=512)
    for d in (65, 96, 129, 512):
        read = MixerShape(batch=8, heads=32, tokens=4096, latents=1, head_dim=d)
        assert resolve("auto", shape=read, dtype=F32, device="cuda")[0].name == "paged"
        assert resolve("paged", shape=read, dtype=F32, device="cuda")[1].backend == "paged"
    over = MixerShape(batch=8, heads=4, tokens=4096, latents=1, head_dim=513)
    assert resolve("auto", shape=over, dtype=F32, device="cuda")[0].name != "paged"
    with pytest.raises(ValueError, match="D=513"):
        resolve("paged", shape=over, dtype=F32, device="cuda")


def test_get_model_mesh_contract():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.train import Trainer
    from repro_torch.config import TrainConfig

    cfg = get_smoke_config("flare_pde")
    with pytest.raises(ValueError, match="'model' axis must be 1"):
        get_model(cfg, device="cpu", mesh=_Mesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="meshes serve the pde family"):
        get_model(get_smoke_config("flare_lm"), device="cpu", mesh=_Mesh((2, 1), ("data", "model")))
    model = get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="the one the model was built with"):
        Trainer(model, TrainConfig(steps=1), _Mesh((1, 1), ("data", "model")))


def test_launcher_trains_on_a_mesh_of_one_cpu_rank(tmp_path):
    """``launch.train --mesh host`` in one process without torchrun: a gloo
    group of one on a free local port, the packed_shard plan, checkpoints."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "flare_pde", "--smoke",
         "--device", "cpu", "--mesh", "host", "--mixer", "packed_shard", "--steps", "2",
         "--global-batch", "2", "--ckpt", str(tmp_path / "ck")],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={k: v for k, v in dict(os.environ, PYTHONPATH=str(REPO / "src")).items()
             if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")})
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert ("train=packed_shard(seq_axes=data;lat_axes=model;block_n=256;block_m=256;"
            "mesh_shape=data1xmodel1)") in out.stdout
    assert "flare-pde-smoke: 2 steps" in out.stdout
    assert (tmp_path / "ck" / "step_2").is_dir()


# the launcher's main() in a process of its own, then the names of the
# process's threads: what is left running when the interpreter tears down
LAUNCHER_THREADS_CODE = r"""
import os, sys
from repro_torch.launch.train import main

main(["--arch", "flare_pde", "--smoke", "--device", "cpu", "--mesh", "host", "--mixer",
      "packed_shard", "--steps", "2", "--global-batch", "2", "--ckpt", sys.argv[1]])
print("THREADS", sorted(open(f"/proc/self/task/{t}/comm").read().strip()
                        for t in os.listdir("/proc/self/task")))
"""


def test_launcher_leaves_no_group_thread_behind(tmp_path):
    """When ``launch.train.main`` returns, the gloo group's threads (its
    workers, its transport loop, the TCP store's server) are gone: nothing
    holds the trainer, its model or the mesh, so they are not left for the
    interpreter's teardown to race (the launcher's abort at exit)."""
    if not os.path.isdir("/proc/self/task"):
        pytest.skip("thread names come from Linux's /proc")
    out = subprocess.run(
        [sys.executable, "-c", LAUNCHER_THREADS_CODE, str(tmp_path / "ck")],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={k: v for k, v in dict(os.environ, PYTHONPATH=str(REPO / "src")).items()
             if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")})
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    names = out.stdout.split("THREADS", 1)[1]
    assert not any(s in names for s in ("gloo", "tcpstore")), names


def test_launcher_mesh_without_a_card_raises():
    from repro_torch.launch.train import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--arch", "flare_pde", "--smoke", "--mesh", "host", "--mixer", "packed_shard"])


def test_encode_stats_merge_to_the_whole_encode():
    """A slice's encode statistics (``core.flare_sp.flare_encode_stats`` and
    the kernels' plain version agree), merged over ragged slices, give the
    encode of all the tokens: Z, its max and its den (fp64, 1e-12)."""
    from repro_torch.core.flare_sp import flare_encode_stats
    from repro_torch.kernels.ref import combine_stats_ref, flare_enc_stats_ref, flare_fused_fwd_ref

    q, k, v = (torch.from_numpy(a).double() for a in inputs(2, 3, 101, 7, 5, seed=3))
    _, mx, num, den = flare_encode_stats(q.float(), k.float(), v.float())
    for got, want in zip((num, mx, den), flare_enc_stats_ref(q.float(), k.float(), v.float())):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    cuts = [0, 40, 41, 101]
    parts = [flare_enc_stats_ref(q, k[:, :, a:b], v[:, :, a:b]) for a, b in zip(cuts, cuts[1:])]
    z, gmax, gden = combine_stats_ref(*(torch.stack(t) for t in zip(*parts)))
    _, z_all, mx_all, den_all, _ = flare_fused_fwd_ref(q, k, v)
    for got, want in ((z, z_all), (gmax, mx_all), (gden, den_all)):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
