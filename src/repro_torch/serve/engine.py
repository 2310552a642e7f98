"""Continuous-batching serving engine: slot-pool state caches, per-request
insertion prefill, retire-and-admit decode loop.

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
token ids are the step's only device-to-host copy. The device page table
is uploaded again only when the host's changed. ``decode_backend=`` pins
the route: "paged" (the kernel), "gather", or "auto" (resolve).

PyTorch runs eagerly, so there is nothing to compile or warm up and no
compile counters; greedy outputs of a request are identical to a solo run
on the same engine geometry, for the paged pool too with ``kv_quant="none"``.
Not ported yet: the prefix cache and copy-on-write, coalesced prefill, the
slot-sharded pool (``mesh=``), span tracing and CUDA-graph capture of the
decode step. The engine's metrics registry (shared with its scheduler and
allocator) records prefill and decode-step times and the pool's events.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.cache import ModelSlotCache
from repro_torch.serve.sampling import make_sampler
from repro_torch.serve.scheduler import ServeRequest, SlotScheduler

MIN_BUCKET = 8   # the smallest prefill bucket; buckets double from it


class ServeEngine:
    def __init__(self, model, net, *, capacity: int = 512, slots: int = 8,
                 temperature: float = 0.0, seed: int = 0, pool_tokens: Optional[int] = None,
                 kv_quant: str = "none", block_size: int = 16, sample: str = "greedy",
                 top_k: int = 0, decode_backend: str = "auto"):
        if decode_backend not in ("auto", "paged", "gather"):
            raise ValueError(f"unknown decode_backend {decode_backend!r} (auto | paged | gather)")
        if model.prefill_into is None or model.init_caches is None:
            raise ValueError(f"{model.cfg.name} (family={model.cfg.family}) has no slot-pool "
                             "serving path (needs init_caches and prefill_into)")
        self.metrics = MetricsRegistry()
        self.model = model
        self.net = net
        self.device = next(net.parameters()).device
        self.capacity = capacity
        self.slots = slots
        self._sampler, needs_gen = make_sampler(temperature, sample, top_k)
        self.generator = (torch.Generator(device=self.device).manual_seed(seed)
                          if needs_gen else None)

        self.paged = pool_tokens is not None
        self._has_paged = False
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
            self._zero_pos = torch.zeros(slots, dtype=torch.int32, device=self.device)
            self._prefill_into = self.slot_cache.make_prefill_into(model.prefill)
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
        m = self.metrics
        self._m_prefill_s = m.histogram("engine.prefill_s", "wall seconds per prefill")
        self._m_step_s = m.histogram("engine.decode_step_s", "wall seconds per fused decode step")
        self._m_tokens_out = m.counter("engine.tokens_out", "generated tokens on retired requests")
        self._next_rid = 0
        self._cur_tok = np.zeros(slots, np.int32)   # the next token fed to each slot
        self.last_logits = None   # the last decode step's logits, on the device
        self.stats = {
            "requests": 0, "tokens_generated": 0, "prefill_s": 0.0, "decode_s": 0.0,
            "decode_steps": 0, "slot_utilization": 0.0, "admitted_peak": 0,
            "cache": self.slot_cache.describe(),
            "decode_backend": self._describe_decode_backend(),
            # logits copied to the host to sample: none, the samplers run on the device
            "sample_host_syncs": 0, "host_syncs_per_step": 0.0,
            "page_waits": 0,   # admission cycles whose queue head waited for pages, not a slot
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
        tails = [d.shape[2:] for d in self.pool["data"]]   # [NB + 1, block, *tail]
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

    def _decode_pool(self, toks: torch.Tensor) -> torch.Tensor:
        """One fused decode step over the whole pool: model decode, then the
        sampler, on the device; returns the sampled ids (not yet copied to
        the host). On the paged pool a slot whose next write position lands
        in an unmapped block gets a page first (its reservation guarantees
        one), and idle lanes write into the trash sink."""
        with torch.no_grad():
            if not self.paged:
                logits, self.pool = self.model.decode_step(self.net, toks, self.pool)
            else:
                from repro_torch.serve.pool import PagedCacheView

                if self._has_paged:
                    for slot in self.sched.running:
                        j = int(self._lengths[slot] % self.capacity) // self.block
                        if self._pt[slot, j] == self.slot_cache.trash:
                            self._pt[slot, j] = self.alloc.append(self._leases[slot])
                            self._pt_dirty = True
                    if self._pt_dirty:
                        self._pt_dev = torch.from_numpy(self._pt).to(self.device)
                        self._pt_dirty = False
                    write_pos = torch.from_numpy(
                        (self._lengths % self.capacity).astype(np.int32)).to(self.device)
                else:
                    write_pos = self._zero_pos
                view = PagedCacheView(self.pool, self._pt_dev, write_pos, self._view_spec)
                logits, out = self.model.decode_step(self.net, toks, view)
                self.pool = out.pool
                if self._has_paged:
                    for slot in self.sched.running:
                        self._lengths[slot] += 1
            self.last_logits = logits
            return self._sampler(logits, self.generator)

    # ------------------------------------------------------------------
    # queueing
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, eos_id: int = -1,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id. It stops at ``max_new_tokens`` or
        at ``eos_id``; one still queued ``deadline_s`` seconds after submission
        is dropped at admission."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.size > self.capacity:
            raise ValueError(f"prompt length {prompt.size} exceeds engine capacity "
                             f"{self.capacity}")
        if self._has_paged:
            need = self._need_pages(prompt.size, max_new_tokens)
            if need > self.alloc.num_blocks:
                raise ValueError(f"request needs {need} pages but the pool only has "
                                 f"{self.alloc.num_blocks} blocks; raise pool_tokens or lower "
                                 "max_new_tokens")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(ServeRequest(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                                       eos_id=eos_id, deadline_s=deadline_s,
                                       submit_t=time.time()))
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
        pages (``stats["page_waits"]``)."""
        if not self._has_paged:
            return True
        need = self._need_pages(len(req.prompt), req.max_new_tokens)
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
        self.stats["tokens_generated"] += 1
        return token == req.eos_id or len(req.tokens) >= req.max_new_tokens

    def _retire(self, slot: int, now: float) -> None:
        req = self.sched.retire(slot, now)
        self._m_tokens_out.inc(len(req.tokens))
        # no state of the request stays behind for the slot's next tenant
        self.pool = self.slot_cache.reset(self.pool, torch.tensor([slot]))
        self._cur_tok[slot] = 0
        if self.paged:
            self.alloc.release(self._leases.pop(slot))
            self._pt[slot] = self.slot_cache.trash
            self._pt_dirty = True
            self._lengths[slot] = 0

    def _prefill(self, req: ServeRequest, slot: int) -> None:
        """Insertion prefill of one admitted request, then its first token,
        sampled on the device."""
        bucket = self._bucket(len(req.prompt))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(req.prompt)] = req.prompt   # right-padded: exact
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "lengths": torch.tensor([len(req.prompt)], dtype=torch.int32,
                                         device=self.device)}
        slots = torch.tensor([slot], device=self.device)
        t0 = time.time()
        with torch.no_grad():
            if self.paged:
                bids = torch.from_numpy(self._stake_pages(req, slot, bucket)[None]).to(self.device)
                logits, self.pool = self._prefill_into(self.net, batch, self.pool, slots, bids)
            else:
                logits, self.pool = self._prefill_into(self.net, batch, self.pool, slots)
            tok = int(self._sampler(logits, self.generator)[0])   # waits for the prefill
        now = time.time()
        self.stats["prefill_s"] += now - t0
        self._m_prefill_s.observe(now - t0)
        self.stats["requests"] += 1
        if self._emit(req, tok, now):
            self._retire(slot, now)
        else:
            self._cur_tok[slot] = tok

    def _admit(self) -> None:
        self._pending_pages = 0
        admitted = self.sched.admit(time.time(), can_admit=self._can_admit if self.paged else None)
        for req, slot in admitted:
            self._prefill(req, slot)

    def check_invariants(self) -> None:
        """Sanitizer: the allocator's mapped blocks are exactly the slots'
        leases', and each slot's page-table row mirrors its lease (the
        unmapped tail at the trash sink). No-op for the dense pool."""
        if not self.paged:
            return
        self.alloc.check_invariants(held=[b for lease in self._leases.values()
                                          for b in lease.mapped])
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
            toks = torch.from_numpy(self._cur_tok[:, None].astype(np.int64)).to(self.device)
            toks_dev = self._decode_pool(toks)
            # the step's only device-to-host copy: S int32 token ids
            # flarecheck: disable=HS003 -- the one sanctioned per-step sync
            out = np.asarray(toks_dev.cpu())
            now = time.time()
            self._note_step(t0, now)
            for slot, req in list(self.sched.running.items()):
                tok = int(out[slot])
                if self._emit(req, tok, now):
                    self._retire(slot, now)
                else:
                    self._cur_tok[slot] = tok
        self._refresh_stats()
        return self.sched.has_work()

    def _note_step(self, t0: float, now: float) -> None:
        """Per-step bookkeeping from the two stamps ``step`` took, outside
        the decode hot scope (no device traffic)."""
        self.stats["decode_s"] += now - t0
        self.stats["decode_steps"] += 1
        self._m_step_s.observe(now - t0)
        self.sched.note_decode_step()

    def _refresh_stats(self) -> None:
        self.stats["host_syncs_per_step"] = (self.stats["sample_host_syncs"]
                                             / max(1, self.stats["decode_steps"]))
        self.stats.update(self.sched.stats())
        if self.paged:
            self.stats["pool"] = self.alloc.stats()

    def run_all(self) -> list:
        """Serve the queue to completion; the generated ids of the requests
        resolved by this call, in submission order (a dropped request gives
        an empty array)."""
        seen = {r.rid for r in self.sched.finished + self.sched.dropped}
        while self.step():
            pass
        new = [r for r in self.sched.finished + self.sched.dropped if r.rid not in seen]
        return [np.asarray(r.tokens, np.int32) for r in sorted(new, key=lambda r: r.rid)]
