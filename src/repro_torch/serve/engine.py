"""Continuous-batching serving engine: slot-pool state caches, per-request
insertion prefill, retire-and-admit decode loop, the prefix cache.

Counterpart of ``repro/serve/engine.py`` on one device. The engine owns a
fixed pool of ``slots`` cache lanes, allocated once. Requests are prefilled
(the prompt right-padded to a power-of-two bucket, its true length in
``batch["lengths"]`` so padding never enters the caches) and inserted into
a free slot; every decode step advances all slots at once, and finished
sequences retire at once: their slot is reset and handed to the next queued
request on the next step.

Two pool layouts:

  - **dense** (default): ``model.init_caches(slots, capacity)``, every
    slot's cache at full capacity (``serve.cache``);
  - **paged** (``pool_tokens=...``): token-axis leaves in block-granular,
    optionally int8 / fp8 storage sized in tokens (``serve.pool``). A
    request is admitted only when the allocator can stake its worst-case
    page count (backpressure in pages, not slots); its prompt bucket's
    pages are mapped at admission and one more as decode crosses a block
    boundary; retirement returns them.

**Fused decode step**: model decode, through the paged pool's
``PagedCacheView`` (the paged-attention kernel when the decode-plan
resolution picks the ``paged`` backend for the pool's decode-read shape;
the dense gather otherwise), then on-device sampling; the ``[S]`` int32
token ids are the step's only device-to-host copy. ``decode_backend=`` pins
the route: "paged" (the kernel), "gather", or "auto" (resolve).

**One device program a step** (``cuda_graph=True``, the default), the
counterpart of the JAX package's compiled step: the step reads static
device buffers (the fed tokens, the page table, the write positions),
filled in place from the host before each step (the page table only when
the host's changed), and writes every cache leaf the model returns back
into the pool's own tensor, so it holds the same addresses from step to
step. On a CUDA device it is captured once an engine as one CUDA graph
(after an eager run that warms cuBLAS, the allocator and the kernel
builds) and replayed every later step; the sampler's generator is
registered with the graph, so each replay draws fresh noise and a seed
repeats a run. On the CPU the same function runs directly each step. Its
build (the capture; on the CPU, binding to the pool's addresses) is counted
in ``stats["decode_compiles"]``; a pool tensor or input buffer whose
address changed since raises. A capture that fails raises: nothing falls
back to eager. A replay runs no kernel wrapper, so the engine adds the
launches its capture recorded (``kernels.ops.add_launches``) and
``launch_counts()`` stays true. ``last_logits`` is then the graph's static
output, overwritten by the next step. ``cuda_graph=False`` keeps the eager
step (the model's returned caches become the pool), the graph route's
oracle, as the JAX engine under ``jax.disable_jit()``.

**Prefix cache** (``prefix_cache=True``; on the paged pool of a model with
``prefill_suffix``, off otherwise): a prompt's full blocks are indexed by
the chain hash of their token ids once prefilled (``pool/blocks.py``). A
later prompt that shares the prefix takes references on those blocks when
it is submitted (held while it queues, walked again at admission) and
stakes only its distinct suffix's pages; its page table points at the
shared blocks, and only the suffix is prefilled (``model.prefill_suffix``,
through ``gqa_extend`` or ``mla_extend``). A prompt made wholly of hit
blocks copies its last block into a private page first (copy-on-write), so
the recomputed last token and every decode append land privately.
``pin_prefix`` holds a template's blocks against eviction. In bf16 compute,
greedy tokens equal the cache-off run's (gqa and dense-FFN mla models; an
MoE's capacity drops depend on which tokens share a batch, and a hit
prefills its suffix alone).

**Coalesced prefill** (``coalesce_prefill=True``, off by default): cold
admissions of one cycle that share a bucket run as one batched prefill
(``stats["coalesced_prefills"]``); batching changes bf16 reduction
grouping, so those lanes are held within a tolerance of a solo run, not
bitwise.

**Tracing** (``tracer=``, a :class:`repro_torch.obs.trace.Tracer`): spans
and instants from the timestamps the stats already take (``enqueue``,
``prefix_walk``, ``admit``, ``prefill``, ``prefix_hit``, ``cow_copy``,
``retire``, ``expire``, one ``decode`` span per 16 steps), one track a
slot; no device work and no host sync, so ``host_syncs_per_step`` and the
greedy tokens are the same with it on. The decode step's model call and
sampling run inside ``obs.scope("serve.decode")`` / ``("serve.sample")``,
which name them in a ``torch.profiler`` trace. ``submit(..., on_token=)``
streams each token as it is sampled.

:meth:`ServeEngine.warmup` front-loads what the steady-state loop would
otherwise do first (JAX's compiles, the MaxText offline-inference idiom):
every (bucket, lanes) prefill and, with the prefix cache, every suffix
bucket and the copy-on-write copy, once each on throwaway inputs into the
trash pages, then the decode step's build; every slot is reset after, so
the pool keeps no trace of it. ``stats["prefill_compiles"]`` counts the
distinct (bucket, lanes) prefill variants run, ``decode_compiles`` the
decode-step builds (1 after warmup, and it does not grow while serving),
``warmup_compiles`` / ``warmup_s`` the warmup's work; the
``engine.prefill_compiles`` / ``engine.decode_compiles`` gauges mirror
them. Greedy outputs of a request are identical to a solo run on the same
engine geometry, for the paged pool too with ``kv_quant="none"``. Not
ported yet: the slot-sharded pool (``mesh=``). The engine's metrics
registry (``metrics=``, shared with its scheduler and allocator) records
prefill and decode-step times, the pool's events and the prefix cache's
hits and copies.
``REPRO_SANITIZE=1`` runs :meth:`ServeEngine.check_invariants` after every
admission cycle and retirement.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.obs import scope
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, TID_ENGINE
from repro_torch.serve.cache import ModelSlotCache
from repro_torch.serve.pool.blocks import chain_hashes
from repro_torch.serve.sampling import make_sampler
from repro_torch.serve.scheduler import ServeRequest, SlotScheduler

MIN_BUCKET = 8     # the smallest prefill bucket; buckets double from it
TRACE_EVERY = 16   # decode steps a "decode" span aggregates


class ServeEngine:
    def __init__(self, model, net, *, capacity: int = 512, slots: int = 8,
                 temperature: float = 0.0, seed: int = 0, pool_tokens: Optional[int] = None,
                 kv_quant: str = "none", block_size: int = 16, coalesce_prefill: bool = False,
                 sample: str = "greedy", top_k: int = 0, decode_backend: str = "auto",
                 prefix_cache: bool = False, tracer=None, metrics=None,
                 cuda_graph: bool = True):
        if decode_backend not in ("auto", "paged", "gather"):
            raise ValueError(f"unknown decode_backend {decode_backend!r} (auto | paged | gather)")
        if model.prefill_into is None or model.init_caches is None:
            raise ValueError(f"{model.cfg.name} (family={model.cfg.family}) has no slot-pool "
                             "serving path (needs init_caches and prefill_into)")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.model = model
        self.net = net
        self.device = next(net.parameters()).device
        self.capacity = capacity
        self.slots = slots
        self.coalesce = coalesce_prefill
        self._sampler, needs_gen = make_sampler(temperature, sample, top_k)
        self.generator = (torch.Generator(device=self.device).manual_seed(seed)
                          if needs_gen else None)

        self.paged = pool_tokens is not None
        self._has_paged = False
        self._prefix_enabled = False
        if self.paged:
            from repro_torch.serve.pool import PagedModelCache

            self.block = block_size
            self.slot_cache = PagedModelCache(model.init_caches, capacity,
                                              pool_tokens=pool_tokens, block=block_size,
                                              quant=kv_quant)
            self._has_paged = bool(self.slot_cache.spec.paged)
            self.alloc = self.slot_cache.allocator()
            self.alloc.bind_metrics(self.metrics)
            self.pool = self.slot_cache.init(slots)
            self._pt = np.full((slots, self.slot_cache.max_pages), self.slot_cache.trash,
                               np.int32)
            self._pt_dev = torch.from_numpy(self._pt).to(self.device)
            self._pt_dirty = False
            self._lengths = np.zeros(slots, np.int64)
            self._leases: dict = {}
            self._prefill_into = self.slot_cache.make_prefill_into(model.prefill)
            # needs token-paged leaves and a suffix prefill (unwindowed gqa or mla);
            # off otherwise, so the flag is safe to pass for any model
            self._prefix_enabled = bool(prefix_cache and self._has_paged
                                        and model.prefill_suffix is not None)
            if self._prefix_enabled:
                self._prefill_suffix = self.slot_cache.make_prefill_suffix(model.prefill_suffix)
        else:
            self.slot_cache = ModelSlotCache(model.init_caches, capacity)
            self.pool = self.slot_cache.init(slots)
            self._prefill_into = (lambda net_, batch, pool, slots_: model.prefill_into(
                net_, batch, pool, slots_, capacity=capacity))
        self._decode_backend_opt = decode_backend
        self._decode_plan = None
        if self._has_paged and decode_backend != "gather":
            self._decode_plan = self._resolve_decode_plan()
        if decode_backend == "paged" and self._decode_plan is None:
            raise ValueError(
                f"{model.cfg.name}: decode_backend='paged' but the paged kernel route is not "
                "eligible (no paged token leaves, or the leaf shapes or the backend contract "
                "reject the kernel)")
        if self.paged:
            self._view_spec = dataclasses.replace(self.slot_cache.spec,
                                                  kernel=self._decode_plan is not None)

        self.sched = SlotScheduler(slots, registry=self.metrics)
        # a request dropped while queued gives back its prefix holds, and
        # every drop is an "expire" instant
        self.sched.on_drop = self._on_drop
        self._match_on_admit = True
        self._pins: list = []               # blocks pin_prefix holds alive
        self._sanitize = os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")
        self._prefix_hit_tokens = 0         # prompt tokens not prefilled again
        self._prefix_prompt_tokens = 0      # prompt tokens admitted (hit and cold)
        self._cow_copies = 0
        m = self.metrics
        self._m_prefill_s = m.histogram("engine.prefill_s", "wall seconds per prefill")
        self._m_step_s = m.histogram("engine.decode_step_s", "wall seconds per fused decode step")
        self._m_tokens_out = m.counter("engine.tokens_out", "generated tokens on retired requests")
        self._m_cow = m.counter("engine.cow_copies", "copy-on-write block copies")
        self._m_hit_tokens = m.counter("engine.prefix_hit_tokens",
                                       "prompt tokens served from the prefix cache")
        self._m_g_prefill_compiles = m.gauge(
            "engine.prefill_compiles", "distinct (bucket, lanes) prefill program variants run")
        self._m_g_decode_compiles = m.gauge("engine.decode_compiles",
                                            "fused decode-step builds (CUDA-graph captures)")
        # the open window of decode steps one "decode" span will cover
        self._win_t0: Optional[float] = None
        self._win_end = 0.0
        self._win_steps = 0
        self._win_toks = 0
        self.tracer.set_track_name(TID_ENGINE, "engine")
        for s in range(slots):
            self.tracer.set_track_name(s + 1, f"slot{s}")
        self._next_rid = 0
        self._cur_tok = np.zeros(slots, np.int32)   # the next token fed to each slot
        self.last_logits = None   # the last decode step's logits, on the device
        # the decode step's static inputs, filled in place before each step
        self._tok_in = torch.zeros(slots, 1, dtype=torch.int64, device=self.device)
        self._wpos = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self.cuda_graph = cuda_graph
        self._graph = None          # the captured step (CUDA device, cuda_graph=True)
        self._graph_out = None      # its static outputs: (ids, logits)
        self._graph_launches = {}   # the kernel launches one replay makes
        self._bound = None          # the addresses the built step holds
        self._decode_compiles = 0
        self._buckets_used: set = set()   # (bucket, lanes) prefills run; ("sfx", bucket, 1)
        self.stats = {
            "requests": 0, "tokens_generated": 0, "prefill_s": 0.0, "decode_s": 0.0,
            "decode_steps": 0, "slot_utilization": 0.0, "admitted_peak": 0,
            "coalesced_prefills": 0,
            "cache": self.slot_cache.describe(),
            "decode_backend": self._describe_decode_backend(),
            # logits copied to the host to sample: none, the samplers run on the device
            "sample_host_syncs": 0, "host_syncs_per_step": 0.0,
            "page_waits": 0,   # admission cycles whose queue head waited for pages, not a slot
            "prefix_cache": self._prefix_enabled, "prefix_hit_rate": 0.0,
            "shared_pages": 0, "cow_copies": 0,
            "prefill_compiles": 0, "decode_compiles": 0, "warmup_compiles": 0, "warmup_s": 0.0,
        }

    # ------------------------------------------------------------------
    # the fused decode step
    # ------------------------------------------------------------------
    def _resolve_decode_plan(self):
        """MixerPolicy resolution for the pool's decode-read shape:
        ``latents=1``, one query row per head over the token axis, which the
        ``paged`` backend scores above every dense backend, so "auto" sends
        kernel-shaped pools through it. Returns the plan (with the pool's
        block and quant) or None where the kernel route is not eligible."""
        from repro_torch.core.dispatch import MixerPlan, MixerShape
        from repro_torch.core.policy import MixerPolicy, resolve_policy

        spec = self.slot_cache.spec
        # [NB + 1, block, *tail]: (H, D), or (D,) read with one head (mla latents)
        tails = [d.shape[2:] if d.dim() == 4 else (1, *d.shape[2:]) for d in self.pool["data"]]
        if any(len(t) != 2 for t in tails):
            return None   # no [NB, block, H, D] kernel layout for this leaf
        shape = MixerShape(batch=self.slots, heads=max(t[0] for t in tails),
                           tokens=self.capacity, latents=1, head_dim=max(t[1] for t in tails))
        policy = (MixerPolicy(backends=("paged",)) if self._decode_backend_opt == "paged"
                  else MixerPolicy())
        try:
            plan = resolve_policy(policy, shape, spec.paged[0].dtype, device=self.device.type,
                                  causal=False)
        except ValueError:
            return None
        if plan.backend != "paged":
            return None
        return MixerPlan(plan.backend, {**plan.params, "block": spec.block,
                                        "quant": spec.quant.name})

    def _describe_decode_backend(self) -> str:
        if not self.paged:
            return "dense"
        if self._decode_plan is not None:
            return self._decode_plan.describe()
        return "paged-gather" if self._has_paged else "dense"

    def _decode_pool(self) -> torch.Tensor:
        """One fused decode step over the whole pool: model decode, then the
        sampler, on the device; returns the sampled ids (not yet copied to
        the host). On the paged pool a slot whose next write position lands
        in an unmapped block gets a page first (its reservation guarantees
        one), and idle lanes write into the trash sink."""
        with torch.no_grad():
            if self._has_paged:
                for slot in self.sched.running:
                    j = int(self._lengths[slot] % self.capacity) // self.block
                    if self._pt[slot, j] == self.slot_cache.trash:
                        self._pt[slot, j] = self.alloc.append(self._leases[slot])
                        self._pt_dirty = True
            self._load_inputs()
            if self.cuda_graph:
                ids = self._static_decode()
            else:
                ids, self.last_logits, self.pool = self._run_step()
            if self._has_paged:
                for slot in self.sched.running:
                    self._lengths[slot] += 1
            return ids

    def _load_inputs(self) -> None:
        """The host's step state into the static input buffers, in place:
        the fed tokens, and on token-paged pools the page table (when it
        changed) and the write positions."""
        self._tok_in.copy_(torch.from_numpy(self._cur_tok[:, None].astype(np.int64)))
        if self._has_paged:
            if self._pt_dirty:
                self._pt_dev.copy_(torch.from_numpy(self._pt))
                self._pt_dirty = False
            self._wpos.copy_(torch.from_numpy((self._lengths % self.capacity).astype(np.int32)))

    def _run_step(self):
        """Model decode and sampling on the static inputs over the pool:
        (ids, logits, the pool the model returned), whose written leaves
        are new tensors (positions, FLARE states, lengths) beside the
        in-place KV rows."""
        if self.paged:
            from repro_torch.serve.pool import PagedCacheView

            view = PagedCacheView(self.pool, self._pt_dev, self._wpos, self._view_spec)
            with scope("serve.decode"):
                logits, out = self.model.decode_step(self.net, self._tok_in, view)
            new = out.pool
        else:
            with scope("serve.decode"):
                logits, new = self.model.decode_step(self.net, self._tok_in, self.pool)
        with scope("serve.sample"):
            return self._sampler(logits, self.generator), logits, new

    def _static_step(self):
        """The step as one capturable function: :meth:`_run_step`, then every
        leaf the model returned copied into the pool's own tensor, so the
        pool keeps its addresses. Returns (ids, logits)."""
        ids, logits, new = self._run_step()
        for dst, src in zip(pytree.tree_leaves(self.pool), pytree.tree_leaves(new)):
            if src is not dst:
                dst.copy_(src)
        return ids, logits

    def _addresses(self) -> tuple:
        """The addresses the built step holds: every pool tensor and the
        static input buffers."""
        tensors = [*pytree.tree_leaves(self.pool), self._tok_in, self._wpos,
                   *([self._pt_dev] if self.paged else [])]
        return tuple(t.data_ptr() for t in tensors if t is not None)   # None: no scales

    def _static_decode(self) -> torch.Tensor:
        """The static step: replayed where it was captured, else run
        directly (the first step on a CUDA device, which then captures it;
        every step on the CPU). Returns the sampled ids."""
        if self._bound is not None and self._addresses() != self._bound:
            raise RuntimeError("a pool tensor or static input buffer was replaced after the decode "
                               "step was built; pool writes must stay in place")
        if self._graph is not None:
            from repro_torch.kernels import ops

            with scope("serve.replay"):
                self._graph.replay()
            ops.add_launches(self._graph_launches)
            ids, self.last_logits = self._graph_out
            return ids
        ids, self.last_logits = self._static_step()
        if self._bound is None:
            self._build_step()
        return ids

    def _build_step(self) -> None:
        """Build the static step once its eager run has warmed cuBLAS, the
        allocator and the kernel builds: on a CUDA device capture it as one
        CUDA graph (the sampler's generator registered with it), whose
        launches are taken back from the counters (a capture records and
        launches nothing) and added on every replay; record the addresses it
        holds. Counted in ``stats["decode_compiles"]``."""
        if self.device.type == "cuda":
            from repro_torch.kernels import ops

            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            before = ops.count_snapshot()
            with torch.cuda.graph(graph):
                out = self._static_step()
            self._graph_launches = ops.count_delta(before, ops.count_snapshot())
            ops.add_launches(self._graph_launches, -1)
            self._graph, self._graph_out = graph, out
        self._bound = self._addresses()
        self._decode_compiles += 1

    # ------------------------------------------------------------------
    # queueing
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, eos_id: int = -1,
               deadline_s: Optional[float] = None, on_token=None) -> int:
        """Queue a request; returns its id. It stops at ``max_new_tokens`` or
        at ``eos_id``; one still queued ``deadline_s`` seconds after submission
        is dropped at admission. ``on_token(rid, token)`` is called with each
        generated token in the step that samples it."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size > self.capacity:
            raise ValueError(f"prompt length {prompt.size} exceeds engine capacity "
                             f"{self.capacity}")
        holds: list = []
        walk = None
        if self._has_paged:
            if self._prefix_enabled and prompt.size + max_new_tokens <= self.capacity:
                # the walk at submit: the hit blocks stay referenced while the
                # request queues; admission walks again for blocks registered since
                w0 = time.time() if self.tracer.enabled else 0.0
                holds = self._acquire_prefix(prompt)
                if self.tracer.enabled:
                    walk = (w0, time.time() - w0)
            # feasibility is always the full prompt's worst case: a hold that
            # is dropped later (deadline, deadlock fallback) must not leave a
            # request that can never stake at the head of the queue
            need = self._need_pages(prompt.size, max_new_tokens)
            if need > self.alloc.num_blocks:
                for b in holds:
                    self.alloc.release_ref(b)
                raise ValueError(f"request needs {need} pages but the pool only has "
                                 f"{self.alloc.num_blocks} blocks; raise pool_tokens or lower "
                                 "max_new_tokens")
        rid = self._next_rid
        self._next_rid += 1
        now = time.time()
        self.sched.submit(ServeRequest(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                                       eos_id=eos_id, deadline_s=deadline_s, on_token=on_token,
                                       submit_t=now, prefix_blocks=holds,
                                       prefix_shard=0 if holds else None))
        if self.tracer.enabled:
            if walk is not None:
                self.tracer.complete("prefix_walk", walk[0], walk[1],
                                     args={"rid": rid, "hit_blocks": len(holds)})
            self.tracer.instant("enqueue", ts=now,
                                args={"rid": rid, "prompt_len": int(prompt.size)})
        return rid

    # ------------------------------------------------------------------
    # paged-pool bookkeeping (host side)
    # ------------------------------------------------------------------
    def _pages(self, tokens: int) -> int:
        return -(-min(tokens, self.capacity) // self.block)

    def _need_pages(self, prompt_len: int, max_new: int) -> int:
        """A request's worst-case pages: its prompt bucket (mapped at
        admission) or its whole decode horizon, whichever is larger; the one
        definition the submit check, the admission gate and the reservation
        share."""
        return max(self._pages(self._bucket(prompt_len)), self._pages(prompt_len + max_new))

    def _can_admit(self, req: ServeRequest) -> bool:
        """The block-aware admission gate: the allocator must be able to
        stake the request's worst case, counting the stakes of earlier
        admissions of this cycle (taken after ``sched.admit`` returns). The
        scheduler asks only with a slot free, so a refusal is a wait for
        pages (``stats["page_waits"]``). With the prefix cache, the gate
        first extends the request's hit walk (blocks registered since it was
        submitted), then stakes only its distinct suffix's pages."""
        if not self._has_paged:
            return True
        if (self._prefix_enabled and self._match_on_admit
                and len(req.prompt) + req.max_new_tokens <= self.capacity):
            req.prefix_shard = 0
            req.prefix_blocks = self._acquire_prefix(req.prompt, held=req.prefix_blocks,
                                                     margin=self._pending_pages)
        if req.prefix_blocks:
            offset, slen = self._split_point(req)
            if offset + self._bucket(slen) > self.capacity:
                # the suffix bucket would run past capacity: take the cold path
                self._drop_prefix_holds(req)
        need = self._suffix_need(req)
        if self.alloc.available() - self._pending_pages < need:
            self.stats["page_waits"] += 1
            return False
        self._pending_pages += need
        return True

    def _stake_pages(self, req: ServeRequest, slot: int, bucket: int) -> np.ndarray:
        """Reserve the request's horizon, map its bucket's pages and point
        the slot's page table at them; returns the mapped ids."""
        self._lengths[slot] = len(req.prompt)
        if not self._has_paged:
            self._leases[slot] = self.alloc.reserve(0)
            return np.zeros(0, np.int32)
        lease = self.alloc.reserve(self._need_pages(len(req.prompt), req.max_new_tokens))
        ids = np.asarray(self.alloc.map(lease, self._pages(bucket)), np.int32)
        self._leases[slot] = lease
        self._pt[slot, :len(ids)] = ids
        self._pt_dirty = True
        return ids

    # ------------------------------------------------------------------
    # the prefix cache
    # ------------------------------------------------------------------
    def _acquire_prefix(self, tokens, held=(), margin: int = 0) -> list:
        """Walk the prompt's chain hashes against the content index, taking
        one reference a hit block and stopping at the first miss. ``held``:
        the blocks the request already references; ``margin``: pages
        committed to earlier admissions of this cycle, which bringing back a
        cached-free block must not eat."""
        out = list(held)
        for h in chain_hashes(tokens, self.block)[len(out):]:
            b = self.alloc.lookup(h)
            if b is None or not self.alloc.acquire(b, margin=margin):
                break
            out.append(b)
        return out

    def _drop_prefix_holds(self, req: ServeRequest) -> None:
        """Give back the references a queued request holds from matching
        (deadline expiry, the deadlock fallback, the gate's cold path)."""
        for b in req.prefix_blocks:
            self.alloc.release_ref(b)
        req.prefix_blocks = []

    def _on_drop(self, req: ServeRequest) -> None:
        """The scheduler's hook for a request dropped while queued: its
        holds go back, and the drop is an "expire" instant."""
        if req.prefix_blocks:
            self._drop_prefix_holds(req)
        self.tracer.instant("expire", ts=req.finish_t, args={"rid": req.rid})

    def _kept_shared(self, req: ServeRequest) -> int:
        """How many of the request's hit blocks stay shared in its page
        table: all of them, or one fewer on full coverage (the whole prompt
        is hit blocks), whose last block is copied so that the recomputed
        last token has a private page to write."""
        k = len(req.prefix_blocks)
        return k - 1 if k and k * self.block >= len(req.prompt) else k

    def _split_point(self, req: ServeRequest):
        """(offset, suffix length): where the prefill resumes. Partial
        coverage at the first block boundary not hit; full coverage at the
        last token alone (into its copied block)."""
        length, k = len(req.prompt), len(req.prefix_blocks)
        if k * self.block >= length:
            return length - 1, 1
        return k * self.block, length - k * self.block

    def _suffix_need(self, req: ServeRequest) -> int:
        """Pages the gate stakes: the horizon less the shared blocks the
        request keeps; a cold request's worst case."""
        if not req.prefix_blocks:
            return self._need_pages(len(req.prompt), req.max_new_tokens)
        return self._pages(len(req.prompt) + req.max_new_tokens) - self._kept_shared(req)

    def _register_blocks(self, req: ServeRequest, slot: int) -> None:
        """Index the prompt's full blocks once their rows are in storage.
        Only requests that cannot wrap register: one that can exceed
        capacity overwrites its low pages, which would poison the index.
        Keep-first registration makes identical prompts converge on the
        first prefill's blocks."""
        if not self._prefix_enabled or len(req.prompt) + req.max_new_tokens > self.capacity:
            return
        for i, h in enumerate(chain_hashes(req.prompt, self.block)):
            self.alloc.register(int(self._pt[slot, i]), h)

    def _stake_suffix(self, req: ServeRequest, slot: int) -> None:
        """Map a hit's pages: the shared blocks become logical pages [0,
        kept) (their references move from the request into the slot's
        lease), private pages cover the rest of the prompt. On full coverage
        the last hit block is copied into the first private page first. No
        write reaches a shared block: they cover positions below the offset,
        and every write is at or past it."""
        length = len(req.prompt)
        kept = self._kept_shared(req)
        lease = self.alloc.reserve(self._suffix_need(req))
        shared, cow_src = req.prefix_blocks[:kept], req.prefix_blocks[kept:]
        self.alloc.adopt(lease, shared)
        priv = self.alloc.map(lease, self._pages(length) - kept)
        self._leases[slot] = lease
        self._lengths[slot] = length
        self._pt[slot, :kept] = shared
        self._pt[slot, kept:self._pages(length)] = priv
        self._pt_dirty = True
        if cow_src:
            # the copy runs on the stream before the suffix prefill's writes
            self.pool = self.slot_cache.copy_block(self.pool, cow_src[0], priv[0])
            self.alloc.release_ref(cow_src[0])   # the hold on the source
            self._cow_copies += 1
            self._m_cow.inc()
            self.tracer.instant("cow_copy", tid=slot + 1, args={"rid": req.rid})
        req.prefix_blocks = []   # the references now live in the lease

    def _prefill_suffix_one(self, req: ServeRequest, slot: int) -> None:
        """A hit's admission: stake its shared and private pages, then
        prefill the suffix alone over the gathered prefix; only rows
        [offset, prompt length) are written back (bucket padding goes to the
        trash block). Never coalesced."""
        offset, slen = self._split_point(req)
        t0 = time.time()
        self._stake_suffix(req, slot)
        self._prefix_hit_tokens += offset
        self._m_hit_tokens.inc(offset)
        self._prefix_prompt_tokens += len(req.prompt)
        bucket = self._bucket(slen)
        self._buckets_used.add(("sfx", bucket, 1))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :slen] = req.prompt[offset:]
        dev = self.device
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "lengths": torch.tensor([slen], dtype=torch.int32, device=dev),
                 "offsets": torch.tensor([offset], dtype=torch.int32, device=dev)}
        with torch.no_grad():
            logits, self.pool = self._prefill_suffix(
                self.net, batch, self.pool, torch.tensor([slot], device=dev),
                torch.from_numpy(self._pt[slot:slot + 1].copy()).to(dev))
            tok = int(self._sampler(logits, self.generator)[0])   # waits for the prefill
        now = time.time()
        self.stats["prefill_s"] += now - t0
        self._m_prefill_s.observe(now - t0)
        if self.tracer.enabled:
            self.tracer.instant("prefix_hit", ts=t0, tid=slot + 1,
                                args={"rid": req.rid, "hit_tokens": offset})
            self.tracer.complete("prefill", t0, now - t0, tid=slot + 1,
                                 args={"rid": req.rid, "kind": "suffix", "bucket": bucket,
                                       "offset": offset})
        self.stats["requests"] += 1
        self._register_blocks(req, slot)
        if self._emit(req, tok, now):
            self._retire(slot, now)
        else:
            self._cur_tok[slot] = tok

    def pin_prefix(self, tokens) -> int:
        """Hold a template's full blocks in the content index against pool
        churn: the engine keeps one reference a block until
        :meth:`release_pins`. A template not yet cached is first prefilled
        as a one-token request. Returns the blocks pinned (0 with the prefix
        cache off, or a template shorter than a block)."""
        if not self._prefix_enabled:
            return 0
        tokens = np.asarray(tokens, np.int32)
        hashes = chain_hashes(tokens, self.block)
        if not hashes:
            return 0
        if not all(self.alloc.lookup(h) is not None for h in hashes):
            rid = self.submit(tokens, max_new_tokens=1)
            while (any(r.rid == rid for r in self.sched.waiting)
                   or any(r.rid == rid for r in self.sched.running.values())):
                self.step()
        pinned = 0
        for h in hashes:
            b = self.alloc.lookup(h)
            if b is None or not self.alloc.acquire(b):
                break
            self._pins.append(b)
            pinned += 1
        return pinned

    def release_pins(self) -> None:
        """Drop every pin (the blocks become cached-free: still indexed,
        reclaimable under pressure)."""
        for b in self._pins:
            self.alloc.release_ref(b)
        self._pins.clear()

    # ------------------------------------------------------------------
    # the continuous loop
    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        b = MIN_BUCKET
        while b < n:
            b *= 2
        return b

    def _emit(self, req: ServeRequest, token: int, now: float) -> bool:
        """Record one generated token; True when the request is done."""
        req.tokens.append(token)
        if req.first_token_t is None:
            req.first_token_t = now
        if req.on_token is not None:
            req.on_token(req.rid, token)
        self.stats["tokens_generated"] += 1
        return token == req.eos_id or len(req.tokens) >= req.max_new_tokens

    def _retire(self, slot: int, now: float) -> None:
        req = self.sched.retire(slot, now)
        self._m_tokens_out.inc(len(req.tokens))
        self.tracer.instant("retire", ts=now, tid=slot + 1,
                            args={"rid": req.rid, "tokens": len(req.tokens)})
        # no state of the request stays behind for the slot's next tenant
        self.pool = self.slot_cache.reset(self.pool, torch.tensor([slot]))
        self._cur_tok[slot] = 0
        if self.paged:
            self.alloc.release(self._leases.pop(slot))
            self._pt[slot] = self.slot_cache.trash
            self._pt_dirty = True
            self._lengths[slot] = 0
            if self._sanitize:
                self.check_invariants()

    def _prefill_group(self, bucket: int, group) -> None:
        """One prefill for ``group`` = [(req, slot), ...], cold admissions
        sharing a bucket (more than one only with ``coalesce_prefill``),
        then their first tokens, sampled on the device."""
        g = len(group)
        self._buckets_used.add((bucket, g))
        tokens = np.zeros((g, bucket), np.int64)
        lens = np.empty(g, np.int32)
        for i, (req, _) in enumerate(group):
            tokens[i, :len(req.prompt)] = req.prompt   # right-padded: exact
            lens[i] = len(req.prompt)
        dev = self.device
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "lengths": torch.from_numpy(lens).to(dev)}
        slots = torch.tensor([slot for _, slot in group], device=dev)
        t0 = time.time()
        with torch.no_grad():
            if self.paged:
                bids = np.stack([self._stake_pages(req, slot, bucket) for req, slot in group])
                logits, self.pool = self._prefill_into(self.net, batch, self.pool, slots,
                                                       torch.from_numpy(bids).to(dev))
            else:
                logits, self.pool = self._prefill_into(self.net, batch, self.pool, slots)
            toks = self._sampler(logits, self.generator).tolist()   # waits for the prefill
        now = time.time()
        if g > 1:
            self.stats["coalesced_prefills"] += 1
        self.stats["prefill_s"] += now - t0
        self._m_prefill_s.observe(now - t0)
        if self.tracer.enabled:
            self.tracer.complete("prefill", t0, now - t0, tid=group[0][1] + 1,
                                 args={"rids": [r.rid for r, _ in group], "bucket": bucket,
                                       "lanes": g})
        self.stats["requests"] += g
        if self._prefix_enabled:
            # cold prompts become donors: their full blocks are indexed, and
            # their tokens count in the hit rate's denominator
            for req, slot in group:
                self._register_blocks(req, slot)
                self._prefix_prompt_tokens += len(req.prompt)
        for (req, slot), tok in zip(group, toks):
            if self._emit(req, tok, now):
                self._retire(slot, now)
            else:
                self._cur_tok[slot] = tok

    def _admit(self) -> None:
        self._pending_pages = 0
        self._match_on_admit = True
        now = time.time()
        admitted = self.sched.admit(now, can_admit=self._can_admit if self.paged else None)
        if (not admitted and self._prefix_enabled and not self.sched.running
                and self.sched.waiting):
            # Deadlock fallback: queued holds (and blocks the gate itself
            # brought back) can keep an idle pool from staking the head of
            # the queue, and nothing will retire to free them. Drop every
            # queued hold (submit checked the worst case without them) and
            # retry once cold, with matching off so the gate cannot take
            # back what was just dropped.
            for r in self.sched.waiting:
                self._drop_prefix_holds(r)
            self._pending_pages = 0
            self._match_on_admit = False
            try:
                admitted = self.sched.admit(now, can_admit=self._can_admit)
            finally:
                self._match_on_admit = True
            if not admitted and not self.sched.running and self.sched.waiting:
                raise RuntimeError(
                    "pool wedged: the queue head cannot stake its pages with every prefix hold "
                    "dropped and nothing running; the pinned blocks leave too little room "
                    "(release_pins or raise pool_tokens)")
        if not admitted:
            return
        if self.tracer.enabled:
            for req, slot in admitted:
                self.tracer.instant("admit", ts=req.admit_t, tid=slot + 1,
                                    args={"rid": req.rid,
                                          "queue_s": round(req.admit_t - req.submit_t, 6)})
        cold = [(r, s) for r, s in admitted if not r.prefix_blocks]
        hits = [(r, s) for r, s in admitted if r.prefix_blocks]
        groups: dict = {}
        for req, slot in cold:
            key = self._bucket(len(req.prompt)) if self.coalesce else req.rid
            groups.setdefault(key, []).append((req, slot))
        for group in groups.values():
            self._prefill_group(self._bucket(len(group[0][0].prompt)), group)
        for req, slot in hits:
            self._prefill_suffix_one(req, slot)
        if self.paged and self._sanitize:
            self.check_invariants()

    def check_invariants(self) -> None:
        """Sanitizer: every allocator refcount is accounted for by a known
        holder (the slots' leases, the pins, the queued requests' prefix
        holds), and each slot's page-table row mirrors its lease's pages
        (the unmapped tail at the trash sink). No-op for the dense pool."""
        if not self.paged:
            return
        refs: dict = {}
        holders = [lease.mapped for lease in self._leases.values()]
        holders += [self._pins] + [r.prefix_blocks for r in self.sched.waiting]
        for blocks in holders:
            for b in blocks:
                refs[b] = refs.get(b, 0) + 1
        self.alloc.check_invariants(external_refs=refs)
        trash = self.slot_cache.trash
        for slot in range(self.slots):
            lease = self._leases.get(slot)
            mapped = lease.mapped if lease is not None else []
            row = self._pt[slot]
            if [int(x) for x in row[:len(mapped)]] != list(mapped) or \
                    not (row[len(mapped):] == trash).all():
                raise RuntimeError(f"sanitizer: slot {slot} page-table row {row.tolist()} "
                                   f"disagrees with its lease's pages {mapped}")

    def step(self) -> bool:
        """Admit queued work into free slots, run one decode step across the
        pool, retire finished sequences. True while work remains."""
        self._admit()
        self.stats["admitted_peak"] = max(self.stats["admitted_peak"], len(self.sched.running))
        if self.sched.running:
            t0 = time.time()
            toks_dev = self._decode_pool()
            # the step's only device-to-host copy: S int32 token ids
            # flarecheck: disable=HS003 -- the one sanctioned per-step sync
            out = np.asarray(toks_dev.cpu())
            now = time.time()
            self._note_step(t0, now, len(self.sched.running))
            for slot, req in list(self.sched.running.items()):
                tok = int(out[slot])
                if self._emit(req, tok, now):
                    self._retire(slot, now)
                else:
                    self._cur_tok[slot] = tok
        if self._win_t0 is not None and not self.sched.running:
            self._flush_window()   # the pool is idle: close the partial window
        self._refresh_stats()
        return self.sched.has_work()

    def _note_step(self, t0: float, now: float, active: int) -> None:
        """Per-step bookkeeping from the two stamps ``step`` took, outside
        the decode hot scope (no device traffic); the tracer gets one
        "decode" span per ``TRACE_EVERY`` steps, never one a step."""
        self.stats["decode_s"] += now - t0
        self.stats["decode_steps"] += 1
        self._m_step_s.observe(now - t0)
        self.sched.note_decode_step()
        if not self.tracer.enabled:
            return
        if self._win_t0 is None:
            self._win_t0 = t0
        self._win_end = now
        self._win_steps += 1
        self._win_toks += active
        if self._win_steps >= TRACE_EVERY:
            self._flush_window()

    def _flush_window(self) -> None:
        """Emit the "decode" span of the open window of steps."""
        if self._win_t0 is None:
            return
        self.tracer.complete("decode", self._win_t0, self._win_end - self._win_t0,
                             args={"steps": self._win_steps, "tokens": self._win_toks})
        self._win_t0 = None
        self._win_steps = 0
        self._win_toks = 0

    def warmup(self, max_prompt_len: Optional[int] = None,
               max_lanes: Optional[int] = None) -> int:
        """Front-load what the steady-state loop would otherwise run first
        (the JAX engine's compiles): one prefill per (bucket, lanes) up to
        ``max_prompt_len`` / ``max_lanes`` not run yet, with the prefix cache
        each suffix bucket (up to the capacity, past which a hit takes the
        cold path) and the copy-on-write copy, all on throwaway inputs into
        the trash pages; then the decode step, with every lane on the trash
        page, run eagerly once and built (captured on a CUDA device). The
        generator's state is put back after, so warmup consumes no entropy,
        and every slot is reset, so the pool keeps no trace of it. Runs
        before serving (no request in a slot). Returns the variants run;
        fills ``stats["warmup_compiles"]`` and ``["warmup_s"]``."""
        if self.sched.running:
            raise RuntimeError("warmup runs before serving: it writes throwaway state into "
                               "every slot, and requests are running")
        t0 = time.time()
        top = min(max_prompt_len or self.capacity, self.capacity)
        buckets = [MIN_BUCKET]
        while buckets[-1] < top:
            buckets.append(buckets[-1] * 2)
        lanes = range(1, (max_lanes or (self.slots if self.coalesce else 1)) + 1)
        dev, n = self.device, 0
        trash = self.slot_cache.trash if self.paged else 0
        with torch.no_grad():
            for g in lanes:
                for bucket in buckets:
                    if (bucket, g) in self._buckets_used:
                        continue
                    batch = {"tokens": torch.zeros((g, bucket), dtype=torch.int64, device=dev),
                             "lengths": torch.ones(g, dtype=torch.int32, device=dev)}
                    slots = torch.zeros(g, dtype=torch.long, device=dev)
                    if self.paged:
                        bids = torch.full((g, self._pages(bucket)), trash, dtype=torch.int32,
                                          device=dev)
                        self._prefill_into(self.net, batch, self.pool, slots, bids)
                    else:
                        self._prefill_into(self.net, batch, self.pool, slots)
                    self._buckets_used.add((bucket, g))
                    n += 1
            if self._prefix_enabled:
                pt_row = torch.full((1, self.slot_cache.max_pages), trash, dtype=torch.int32,
                                    device=dev)
                for bucket in (b for b in buckets if b <= self.capacity):
                    if ("sfx", bucket, 1) in self._buckets_used:
                        continue
                    batch = {"tokens": torch.zeros((1, bucket), dtype=torch.int64, device=dev),
                             "lengths": torch.ones(1, dtype=torch.int32, device=dev),
                             "offsets": torch.zeros(1, dtype=torch.int32, device=dev)}
                    self._prefill_suffix(self.net, batch, self.pool,
                                         torch.zeros(1, dtype=torch.long, device=dev), pt_row)
                    self._buckets_used.add(("sfx", bucket, 1))
                    n += 1
                self.slot_cache.copy_block(self.pool, trash, trash)
                n += 1
            # the decode step over idle lanes: page tables at the trash sink,
            # positions and fed tokens 0
            state = self.generator.get_state() if self.generator is not None else None
            self._cur_tok[:] = 0
            self._load_inputs()
            build = self.cuda_graph and self._bound is None
            if not self.cuda_graph:
                self._run_step()     # the eager step: warmed, nothing to build
            elif build:
                self._static_step()
            if state is not None:
                self.generator.set_state(state)
            if build:
                self._build_step()
                n += 1
            self.slot_cache.reset(self.pool, torch.arange(self.slots))
        self.stats["warmup_compiles"] += n
        dur = time.time() - t0
        self.stats["warmup_s"] += dur
        self.tracer.complete("warmup", t0, dur, args={"compiles": n})
        self._refresh_stats()
        return n

    def _refresh_stats(self) -> None:
        self.stats["prefill_compiles"] = len(self._buckets_used)
        self.stats["decode_compiles"] = self._decode_compiles
        self._m_g_prefill_compiles.set(len(self._buckets_used))
        self._m_g_decode_compiles.set(self._decode_compiles)
        self.stats["host_syncs_per_step"] = (self.stats["sample_host_syncs"]
                                             / max(1, self.stats["decode_steps"]))
        self.stats.update(self.sched.stats())
        if self.paged:
            self.stats["pool"] = self.alloc.stats()
            self.stats["prefix_hit_rate"] = (self._prefix_hit_tokens / self._prefix_prompt_tokens
                                             if self._prefix_prompt_tokens else 0.0)
            self.stats["shared_pages"] = self.alloc.shared_blocks()
            self.stats["cow_copies"] = self._cow_copies
            self.stats["pinned_pages"] = len(self._pins)

    def run_all(self) -> list:
        """Serve the queue to completion; the generated ids of the requests
        resolved by this call, in submission order (a dropped request gives
        an empty array)."""
        seen = {r.rid for r in self.sched.finished + self.sched.dropped}
        while self.step():
            pass
        new = [r for r in self.sched.finished + self.sched.dropped if r.rid not in seen]
        return [np.asarray(r.tokens, np.int32) for r in sorted(new, key=lambda r: r.rid)]
