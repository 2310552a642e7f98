"""Launch-parameter autotuner for the FLARE kernel backends.

Counterpart of ``repro/backends/autotune.py``. The kernels' speed hangs on
their launch parameters, and the best choice depends on the problem shape,
the dtype and the card, none of which a constant can know. This module

  * proposes candidates for a :class:`~repro_torch.core.dispatch.MixerShape`
    per parameter *kind*,
  * times them with a runner the backend supplies, and
  * keeps the winner in a JSON cache keyed by ``(kind, device, dtype, N, M,
    D, H[, mesh], torch+CUDA version)``, so a process never pays the search
    twice. The runtime version is in the key because a winner timed under
    one toolkit is no evidence about another; entries under the reference's
    un-versioned key format are still read as a fallback hit. The batch is
    not in the key, as in the reference.

The launch parameters (``_KIND_PARAMS``), those of ``kernels/flare.py``:

  ``"tiles"`` (the ``pallas`` backend: the encode and decode kernels)
      ``block_m``: rows a block, the encode's latent rows and the decode's
      token rows (16 * 4 * MT for a row tile MT the library is built with,
      ``kernels/flare.py::row_choices``); ``block_n``: tokens a split of the
      encode's N axis, so that it runs in ceil(N / block_n) splits.
  ``"packed"`` (the ``packed`` and ``packed_shard`` backends: the fused
  forward and backward)
      ``block_n``: the same split, shared by the forward's encode and the
      backward's passes (a) and (c); ``block_m``: the forward kernels' rows a
      block (the backward's row tiles are fixed).

The reference's ``packed`` kind also searches ``pack``, the heads packed
into a TPU's 128 lanes; nothing is lane-packed on Hopper
(``backends/packed.py``), so it has no counterpart here.

The defaults (``default_tiles``, ``default_packed``) are what the kernels
launch when no plan names a parameter: ``row_tiles<D>()`` rows and the split
of ``csrc/flare.cu::flare_encode_splits``, so an untuned plan launches
exactly what the kernels did before they were tunable. Every candidate is a
configuration the built library has, and one the wrappers accept before
they launch (``kernels/flare.py::check_tiles``): a refused candidate raises
before any launch and loses the race.

Timing runs only when asked for (``MixerPolicy(autotune=True)`` or
``REPRO_AUTOTUNE=1``) and only on the card, where the backends offer a
runner; the default lookup is cache hit or defaults. The cache is its own
file, ``REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro_torch/autotune.json``): a winner the JAX package found for
a TPU is never read as one of the port's, not even through the legacy key.

A plan carries its parameters with the shape they were chosen for
(``params["shape"]``); :func:`launch_params` gives a call at another shape
what the cache holds for that shape, or its defaults, and times nothing.

Concurrency: a write re-reads the file, merges its entry into what other
processes stored meanwhile and publishes by temp file + ``os.replace``, so a
reader never sees a partial file. Two simultaneous writers can still drop
one entry; the cost is a re-tune of that shape, never a wrong result. A
corrupt cache, or a malformed entry in one, is a miss, never an error.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Callable, Iterable, Optional

import torch

from repro_torch.core.dispatch import MixerPlan, MixerShape, _dtype_name
from repro_torch.kernels.flare import (
    MIN_SPLIT_TOKENS,
    card_sms,
    check_tiles,
    default_rows,
    default_splits,
    row_choices,
)
from repro_torch.obs.metrics import REGISTRY

_MEM_CACHE: dict = {}  # path -> {key: entry} mirror of the JSON file
_FORCE: list = []  # policy-scoped overrides of the REPRO_AUTOTUNE env var

# lookups are module-level (plan resolution has no engine or trainer to hand
# a registry in), and one process shares one cache file anyway
_M_HITS = REGISTRY.counter(
    "autotune.cache_hits", "best_params lookups served from the JSON cache")
_M_MISSES = REGISTRY.counter(
    "autotune.cache_misses", "lookups that fell through to measure/heuristic")
_M_MEASURED = REGISTRY.counter(
    "autotune.measured", "candidate sweeps actually timed on device")

H100_SMS = 132   # the SMs the defaults assume where no card is visible
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


def cache_path() -> str:
    return os.environ.get(
        CACHE_ENV, os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"))


def autotune_enabled() -> bool:
    if _FORCE:
        return _FORCE[-1]
    return os.environ.get("REPRO_AUTOTUNE", "0") not in ("", "0", "false")


@contextlib.contextmanager
def forced(enabled: bool):
    """Scoped override of the autotune opt-in: how ``MixerPolicy.autotune``
    reaches the plan builders without threading kwargs through the registry."""
    _FORCE.append(bool(enabled))
    try:
        yield
    finally:
        _FORCE.pop()


def runtime_version() -> str:
    """The torch + CUDA version tag in cache keys: a winner timed under one
    toolkit is no evidence about another."""
    return f"torch{torch.__version__}+cuda{torch.version.cuda}"


def device_name(kind: str) -> str:
    """The device in a cache key: the card's name for ``"cuda"`` where a card
    is visible, else the device kind itself."""
    if kind == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return kind


def _base_key(shape: MixerShape, dtype, device: str, kind: str,
              mesh: Optional[tuple] = None) -> str:
    base = (f"{device}|{_dtype_name(dtype)}|N{shape.tokens}|M{shape.latents}"
            f"|D{shape.head_dim}|H{shape.heads}")
    if mesh:
        # a winner for a per-shard slice is no evidence about the one-device
        # problem (or another mesh): sharded entries get their own keys
        base = f"{base}|mesh{'x'.join(str(int(s)) for s in mesh)}"
    # the "tiles" keys carry no kind prefix, as the reference's
    return base if kind == "tiles" else f"{kind}|{base}"


def cache_key(shape: MixerShape, dtype, device: str, kind: str = "tiles",
              mesh: Optional[tuple] = None) -> str:
    """The (runtime-versioned) key new winners are stored under."""
    return f"{_base_key(shape, dtype, device, kind, mesh)}|{runtime_version()}"


def legacy_cache_key(shape: MixerShape, dtype, device: str, kind: str = "tiles",
                     mesh: Optional[tuple] = None) -> str:
    """The un-versioned key format (the reference's legacy key, letter for
    letter), read as a fallback hit."""
    return _base_key(shape, dtype, device, kind, mesh)


def _read_disk(path: str) -> dict:
    """Uncached read straight from disk; {} for missing/corrupt/non-dict."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _load(path: str) -> dict:
    if path in _MEM_CACHE:
        return _MEM_CACHE[path]
    data = _read_disk(path)
    _MEM_CACHE[path] = data
    return data


def _store(path: str, key: str, entry: dict) -> None:
    """Publish one entry. Re-reads the file first so entries written by
    concurrent processes survive, and replaces atomically so readers never
    observe a partial file."""
    merged = {**_MEM_CACHE.get(path, {}), **_read_disk(path), key: entry}
    _MEM_CACHE[path] = merged
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization; never fail the computation


# ---------------------------------------------------------------------------
# Candidates and defaults, per parameter kind
# ---------------------------------------------------------------------------

# param names per kind; doubles as entry validation for cache hits
_KIND_PARAMS = {
    "tiles": ("block_m", "block_n"),
    "packed": ("block_n", "block_m"),
}
SPLITS = (1, 2, 4, 8, 16, 32)   # the token splits searched besides the default


def _sms(sms: Optional[int]) -> int:
    if sms is not None:
        return sms
    return card_sms(torch.cuda.current_device()) if torch.cuda.is_available() else H100_SMS


def _split_choices(shape: MixerShape, sms: Optional[int]) -> list:
    """``block_n`` for the default split and for each of SPLITS that keeps
    1,024 tokens a split (the default rule's floor), fewest splits first."""
    n = shape.tokens
    splits = {s for s in SPLITS if s == 1 or n // s >= MIN_SPLIT_TOKENS}
    splits.add(default_splits(shape.batch * shape.heads, shape.latents, n, _sms(sms)))
    return list(dict.fromkeys(-(-n // s) for s in sorted(splits)))


def tile_candidates(shape: MixerShape, sms: Optional[int] = None) -> list:
    """Every built row tile at the shape's head dim x the split choices."""
    return [{"block_m": bm, "block_n": bn} for bm in row_choices(shape.head_dim)
            for bn in _split_choices(shape, sms)]


def default_tiles(shape: MixerShape, sms: Optional[int] = None) -> dict:
    """What the kernels launch when no plan names a parameter:
    ``row_tiles<D>()`` rows and the split ``flare_encode_splits`` picks on a
    card of ``sms`` multiprocessors (default: the visible card's, else an
    H100's)."""
    splits = default_splits(shape.batch * shape.heads, shape.latents, shape.tokens, _sms(sms))
    return {"block_m": default_rows(shape.head_dim), "block_n": -(-shape.tokens // splits)}


def packed_candidates(shape: MixerShape, sms: Optional[int] = None) -> list:
    """The fused kernels' candidates: those of "tiles", in this kind's order."""
    return [{"block_n": c["block_n"], "block_m": c["block_m"]}
            for c in tile_candidates(shape, sms)]


def default_packed(shape: MixerShape, sms: Optional[int] = None) -> dict:
    tiles = default_tiles(shape, sms)
    return {"block_n": tiles["block_n"], "block_m": tiles["block_m"]}


_CANDIDATES = {"tiles": tile_candidates, "packed": packed_candidates}
_DEFAULTS = {"tiles": default_tiles, "packed": default_packed}


def _valid(shape: MixerShape, params: dict) -> bool:
    """Whether the kernels take these parameters at this shape."""
    try:
        check_tiles("autotune", shape.head_dim, shape.tokens, params.get("block_m"),
                    params.get("block_n"))
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# Measurement and lookup
# ---------------------------------------------------------------------------


def measure_tiles(shape: MixerShape, dtype, device: str,
                  runner: Callable[[dict], float],
                  candidates: Optional[Iterable[dict]] = None,
                  kind: str = "tiles", mesh: Optional[tuple] = None) -> dict:
    """Time each candidate with ``runner(params) -> seconds`` and cache the
    winner, with every candidate's time (``timed``). Returns the winning
    param dict."""
    cands = list(candidates) if candidates is not None else _CANDIDATES[kind](shape)
    _M_MEASURED.inc()
    timed = []
    for params in cands:
        try:
            dt = runner(params)
        except Exception:  # noqa: BLE001 -- an illegal candidate just loses the race
            continue
        timed.append((dt, params))
    if not timed:
        return _DEFAULTS[kind](shape)
    best_dt, best = min(timed, key=lambda p: p[0])
    _store(cache_path(), cache_key(shape, dtype, device, kind, mesh), {
        **best, "us": best_dt * 1e6, "candidates": len(timed),
        "timed": [{**params, "us": dt * 1e6} for dt, params in timed],
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    })
    return best


def _lookup(shape: MixerShape, dtype, device: str, kind: str,
            mesh: Optional[tuple]) -> Optional[dict]:
    """The cached winner (versioned key first, then legacy), or None; counted
    as a hit or a miss."""
    cached = _load(cache_path())
    for key in (cache_key(shape, dtype, device, kind, mesh),
                legacy_cache_key(shape, dtype, device, kind, mesh)):
        entry = cached.get(key)
        if entry is not None:
            try:
                out = {p: int(entry[p]) for p in _KIND_PARAMS[kind]}
            except (KeyError, TypeError, ValueError):
                continue  # corrupt/partial entry: fall through
            if _valid(shape, out):
                _M_HITS.inc()
                return out
    _M_MISSES.inc()
    return None


def best_params(shape: MixerShape, dtype, device: str, *, kind: str = "tiles",
                runner: Optional[Callable[[dict], float]] = None,
                autotune: Optional[bool] = None,
                mesh: Optional[tuple] = None) -> dict:
    """Cache hit -> the cached winner; miss -> time the candidates if
    autotuning is on and a runner is given, else the defaults. A malformed
    entry (or one the kernels would refuse at this shape) is a miss, never
    an error. The runtime-versioned key is tried first, then the legacy
    one; new winners are stored versioned only. ``mesh`` (a shard-count
    tuple) keys a sharded backend's per-shard winners apart."""
    hit = _lookup(shape, dtype, device, kind, mesh)
    if hit is not None:
        return hit
    if (autotune if autotune is not None else autotune_enabled()) and runner is not None:
        best = measure_tiles(shape, dtype, device, runner, kind=kind, mesh=mesh)
        return {p: best[p] for p in _KIND_PARAMS[kind]}
    return _DEFAULTS[kind](shape)


def best_tiles(shape: MixerShape, dtype, device: str, *,
               runner: Optional[Callable[[dict], float]] = None,
               autotune: Optional[bool] = None) -> dict:
    """The ``"tiles"`` kind's lookup (the reference's alias)."""
    return best_params(shape, dtype, device, kind="tiles", runner=runner, autotune=autotune)


# ---------------------------------------------------------------------------
# The backends' side: runners, plans and a call's parameters
# ---------------------------------------------------------------------------


def cuda_runner(shape: MixerShape, dtype, call, *, backward: bool, reps: int = 3):
    """The timing callable a backend offers on the card: ``runner(params)``
    -> seconds, the median of ``reps`` calls of ``call(q, k, v, **params)``
    (with its backward for a seeded dy when ``backward``) after one warm-up,
    timed by CUDA events. The inputs, drawn once from a seeded
    ``torch.Generator`` on the card, are q [H, M, D] and k, v as the model's
    strided [B, H, N, D] views of [B, N, H, D]."""
    inputs = []

    def draw():
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, h, n, m, d = shape.batch, shape.heads, shape.tokens, shape.latents, shape.head_dim
        rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        q = (rand(h, m, d) * d ** -0.5).requires_grad_(backward)
        k, v = (rand(b, n, h, d).requires_grad_(backward) for _ in range(2))
        inputs.extend((q, k, v, rand(b, n, h, d).transpose(1, 2)))

    def run(params: dict) -> float:
        if not inputs:
            draw()
        q, k, v, dy = inputs

        def once():
            with torch.set_grad_enabled(backward):
                y = call(q, k.transpose(1, 2), v.transpose(1, 2), **params)
                if backward:
                    torch.autograd.grad(y, (q, k, v), dy)

        once()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            once()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times) / 1e3

    return run


def plan_params(kind: str, shape: MixerShape, dtype, device: str, call, *,
                backward: bool, mesh: Optional[tuple] = None) -> dict:
    """A kernel backend's plan parameters for ``device`` (a device kind): the
    cached winner, a timed search when autotuning is on and a card is
    visible (``call`` is what the runner times), or the defaults; with the
    shape they were chosen for under ``"shape"``."""
    on_card = device == "cuda" and torch.cuda.is_available()
    runner = cuda_runner(shape, dtype, call, backward=backward) if on_card else None
    params = best_params(shape, dtype, device_name(device), kind=kind, runner=runner,
                         mesh=mesh)
    return {**params, "shape": shape}


def launch_params(plan: MixerPlan, q: torch.Tensor, k: torch.Tensor, kind: str,
                  mesh: Optional[tuple] = None) -> dict:
    """The launch parameters of one call of ``plan`` on q [H, M, D], k
    [B, H, N, D]: the plan's own where it was resolved for this call's shape
    (or names them with no shape), else what the cache holds for the call's
    shape, else none (the kernels' defaults for the call). Times nothing."""
    shape = MixerShape.from_qkv(q, k)
    params = plan.params
    names = _KIND_PARAMS[kind]
    if params.get("shape") in (None, shape) and all(p in params for p in names):
        return {p: params[p] for p in names}
    return _lookup(shape, k.dtype, device_name(k.device.type), kind, mesh) or {}
