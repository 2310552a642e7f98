"""Fault-tolerant training loop, on one device or sequence-parallel over a mesh.

Counterpart of ``repro/train/trainer.py`` without gradient compression:
  - step-keyed data: ``batch_fn(step)``, so a restart sees the same batches;
  - with a mesh (``Trainer(model, tcfg, mesh)``, the model built with the
    same mesh): every rank holds the whole model and takes its slice of each
    example's tokens of ``batch_fn(step)``; the gradients are summed over
    the ranks before clipping, so the clip sees the global norm. The JAX
    trainer shards parameters FSDP-style and lets GSPMD reshard the tokens;
    the port is explicitly sequence-parallel, with the same loss and update.
    Rank 0 writes the checkpoints (the JAX layout) and every rank restores
    them;
  - async checkpoints every ``checkpoint_every`` steps; SIGTERM/SIGINT during
    ``fit`` make the loop stop after the current step and save once more,
    blocking;
  - resume from the latest checkpoint: parameters restored, the optimizer's
    step fast-forwarded, its moments restarted at zero (a warm restart, as
    in the JAX trainer; ``save_full_state`` writes the moments too);
  - straggler watchdog: a step slower than ``straggler_factor`` times the
    running median fires ``on_straggler``;
  - metrics (steps, per-step data and step seconds, checkpoints,
    stragglers) and, with a tracer, one span per step.
"""
from __future__ import annotations

import contextlib
import logging
import signal
import statistics
import time
import zipfile
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.distributed.compat import axis_group, barrier, group_rank
from repro_torch.distributed.sharding import shard_tokens
from repro_torch.interop import from_jax_flat, jax_keys, to_jax_flat
from repro_torch.obs import annotate
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.adamw import init_adamw
from repro_torch.train.steps import make_train_step

log = logging.getLogger("repro_torch.train")


class Trainer:
    def __init__(
        self,
        model,
        tcfg: TrainConfig,
        mesh=None,
        *,
        num_microbatches: int = 1,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        straggler_factor: float = 3.0,
        tracer=None,
        metrics=None,
    ):
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError("the trainer's mesh must be the one the model was built with "
                             "(get_model(cfg, mesh=mesh)): its mixer plans decide how the "
                             "ranks share each example's tokens")
        self.model = model
        self.tcfg = tcfg
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._m_steps = self.metrics.counter("train.steps", "optimizer steps completed")
        self._m_data_s = self.metrics.histogram("train.data_s", "per-step host data feed seconds")
        self._m_step_s = self.metrics.histogram(
            "train.step_s", "per-step device step seconds (incl. metric sync)")
        self._m_ckpts = self.metrics.counter("train.checkpoints", "checkpoint saves issued")
        self._m_stragglers = self.metrics.counter(
            "train.stragglers", "steps flagged by the straggler watchdog")
        self.on_straggler = on_straggler or (
            lambda step, dt, med: log.warning("straggler: step %d took %.3fs (median %.3fs)",
                                              step, dt, med))
        self.straggler_factor = straggler_factor
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self._stop = False
        self._step_times: list = []
        self.step = 0
        self._build()

    def _build(self):
        self.net = self.model.init(self.tcfg.seed)
        self.device = next(self.net.parameters()).device
        keys = jax_keys(self.net.state_dict())
        try:
            last, restored = self.ckpt.restore_latest(keys)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            log.warning("checkpoint restore failed (%s); starting fresh", e)
            last, restored = None, None
        if restored is not None:
            self.net.load_state_dict(from_jax_flat(restored), strict=True)
            self.step = last
            log.info("resumed from step %d", last)
        self.opt_state = init_adamw(dict(self.net.named_parameters()))
        self.opt_state.step = self.step
        # the ranks that share the parameters (all of them: heads stay whole)
        self._group = (None if self.mesh is None
                       else axis_group(self.mesh, self.mesh.mesh_dim_names))
        self._train_step = make_train_step(self.model.loss, self.tcfg,
                                           num_microbatches=self.num_microbatches,
                                           grad_group=self._group)

    @contextlib.contextmanager
    def _signals(self):
        """SIGTERM/SIGINT handled by the trainer for the extent of a fit, the
        previous handlers restored after. A handler left installed would hold
        the trainer, and with it the model and its process groups, until the
        interpreter's own teardown, which then races the groups' threads.
        A signal whose handler was installed outside Python (``getsignal``
        gives None) is left alone: that handler could not be restored."""
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            handler = signal.getsignal(sig)
            if handler is None:
                continue
            try:
                signal.signal(sig, self._handle_term)
            except ValueError:   # not the main thread (tests)
                continue
            previous[sig] = handler
        try:
            yield
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _handle_term(self, signum, frame):  # noqa: ARG002
        log.warning("signal %s received: will checkpoint and stop", signum)
        self._stop = True

    def fit(self, batch_fn: Callable[[int], dict], *, steps: Optional[int] = None):
        """batch_fn(step) -> global batch (tensors or numpy: the pde
        family's points, or the LMs' int32 ``tokens`` and ``labels``, moved
        to the device in their dtype). Returns the metric history, one dict
        of floats per step."""
        with self._signals():
            return self._fit(batch_fn, steps or self.tcfg.steps)

    def _fit(self, batch_fn: Callable[[int], dict], steps: int):
        history = []
        while self.step < steps and not self._stop:
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch_fn(self.step).items()}
            if self.mesh is not None:
                batch = shard_tokens(batch, self.mesh)
            t1 = time.time()   # host data feed done; device step begins
            with annotate("train/step"):
                _, self.opt_state, metrics = self._train_step(self.net, self.opt_state, batch)
                # float() waits for the step, so everything after t1 is the
                # device step and the metric readback
                metrics = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            dt = now - t0
            self._m_steps.inc()
            self._m_data_s.observe(t1 - t0)
            self._m_step_s.observe(now - t1)
            if self.tracer.enabled:
                self.tracer.complete(
                    "train_step", t0, dt, cat="train",
                    args={"step": self.step, "data_s": round(t1 - t0, 6),
                          "step_s": round(now - t1, 6), "loss": metrics.get("loss")})
            self._watchdog(dt)
            self.step += 1
            metrics["step"] = self.step
            metrics["time"] = dt
            history.append(metrics)
            if self.step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f gnorm %.3f lr %.2e (%.2fs)", self.step,
                         metrics["loss"], metrics["grad_norm"], metrics["lr"], dt)
            if self.step % self.tcfg.checkpoint_every == 0 and self._writes:
                self.ckpt.save(self.step, to_jax_flat(self.net.state_dict()))
                self._m_ckpts.inc()
                self.tracer.instant("checkpoint", cat="train", args={"step": self.step})
        # final (blocking) save, also the preemption path; then every rank
        # waits for it, so a restore on any rank sees it
        if self._writes:
            self.ckpt.save(self.step, to_jax_flat(self.net.state_dict()), blocking=True)
        barrier(self._group, self.device)
        return history

    @property
    def _writes(self) -> bool:
        """Whether this process writes checkpoints: rank 0 of a mesh, or the
        only process."""
        return group_rank(self._group) == 0

    def _watchdog(self, dt: float):
        self._step_times.append(dt)
        if len(self._step_times) >= 5:
            med = statistics.median(self._step_times[-50:])
            if dt > self.straggler_factor * med:
                self._m_stragglers.inc()
                self.on_straggler(self.step, dt, med)

    def save_full_state(self):
        """Blocking save of the parameters and the optimizer moments, under
        the JAX trainer's ``params/``, ``m/`` and ``v/`` prefixes."""
        if not self._writes:
            return
        flat = {}
        for prefix, tensors in (("params", self.net.state_dict()), ("m", self.opt_state.m),
                                ("v", self.opt_state.v)):
            flat.update({f"{prefix}/{k}": a for k, a in to_jax_flat(tensors).items()})
        self.ckpt.save(self.step, flat, blocking=True)
