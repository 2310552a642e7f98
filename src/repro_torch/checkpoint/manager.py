"""Checkpoints: async, atomic, verified; the JAX package's layout.

Counterpart of ``repro/checkpoint/manager.py``, with the same files, so a
checkpoint written by either package restores in the other:

    <dir>/step_<N>/arrays.npz   leaves keyed by "/"-joined JAX paths
    <dir>/step_<N>/meta.json    step, wall time, per-leaf shape/dtype/crc32
    <dir>/LATEST                the newest complete step dir

Leaves are a flat ``{path: array}`` dict (``interop.to_jax_flat`` turns a
``state_dict`` into one). ``save`` copies the leaves to host numpy arrays at
once and writes them in a background thread (``wait`` joins); writes go to
``step_<N>.tmp``, are fsync'd, then renamed, so a crash never leaves a
half-written step behind ``LATEST``. Every leaf's crc32 is checked on
restore. Only the newest ``keep`` complete steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Iterable, Mapping, Optional

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # not npz-portable: the lossless fp32 widening
            leaf = leaf.float()
        return np.ascontiguousarray(leaf.numpy())
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (``tobytes()``'s), read in place:
    no copy of a multi-GB leaf."""
    return zlib.crc32(np.ascontiguousarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, leaves: Mapping[str, object], *, blocking: bool = False) -> None:
        """Snapshot now (device->host copy), write in the background unless
        ``blocking``. One save is in flight at a time."""
        self.wait()
        flat = {k: _host(v) for k, v in leaves.items()}

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            meta = {"step": step, "time": time.time(),
                    "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                                   "crc32": _crc32(v)} for k, v in flat.items()}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            latest_tmp = os.path.join(self.dir, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(f"step_{step}")
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(self.dir, name, "meta.json"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                return int(name.split("_")[1])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, keys: Optional[Iterable[str]] = None) -> dict:
        """``{path: numpy array}`` of step ``step`` (only ``keys`` when given),
        each leaf checked against its crc32."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        out = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key in (meta["leaves"] if keys is None else keys):
                arr = data[key]
                if _crc32(arr) != meta["leaves"][key]["crc32"]:
                    raise IOError(f"checkpoint corruption detected at leaf {key}")
                out[key] = arr
        return out

    def restore_latest(self, keys: Optional[Iterable[str]] = None):
        """(step, leaves) of the newest complete step, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, keys)
