#!/usr/bin/env python3
"""nvcc's build seconds of the port's CUDA kernels, for one or more checkouts.

    python3 scripts/torch_build_seconds.py <root> [<root> ...]

For each checkout (in the order given, so that parent, change, change,
parent runs in one call compare on one machine) this compiles every source
its ``kernels/_build.py`` lists, with that file's own flags, one nvcc
process a source, all started together as the build does, into a temporary
directory, and prints the seconds from the start to each source's object
and to the last. Nothing is linked or loaded. Imports neither JAX nor the
port's package: each checkout's ``_build.py`` is loaded from its path.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path


def build_seconds(root: Path) -> dict:
    path = root / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(root))}", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    nvcc = build._nvcc()
    done = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o",
                                   str(Path(tmp) / f"{Path(s).stem}.o"), str(build.CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s in build.SOURCES]

        def drain(i: int) -> None:
            out = procs[i].communicate()[0]
            done[build.SOURCES[i]] = round(time.perf_counter() - t0, 1)
            if procs[i].returncode != 0:
                print(out[-3000:], file=sys.stderr)

        readers = [threading.Thread(target=drain, args=(i,)) for i in range(len(procs))]
        for r in readers:
            r.start()
        for r in readers:
            r.join()
    failed = [s for s, p in zip(build.SOURCES, procs) if p.returncode != 0]
    if failed:
        raise SystemExit(f"{root}: nvcc failed on {failed}")
    return {"all": max(done.values()), **done}


def main() -> int:
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [Path(".").resolve()]
    for root in roots:
        print(f"build seconds {root}: {build_seconds(root)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
