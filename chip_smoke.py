#!/usr/bin/env python3
"""Drive the PyTorch port's FLARE inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports only ``repro_torch`` (from
``src/``), never JAX or the JAX package. Phases, each of which raises on
failure so the script exits non-zero:

1. the card: exits non-zero without CUDA; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles ``src/repro_torch/csrc/flare.cu`` with nvcc and prints the
   seconds taken and ptxas's register/shared-memory use of the D=8 kernels;
3. kernels on random operands: each CUDA kernel (encode, decode, fused
   forward) against its plain PyTorch version, bf16 at full width (H=8,
   M=2048, D=8, B=1, N=40,000) and a ragged shape (M=16, N=97) in fp32 and
   bf16. Each output is held by absolute error (fp32 1e-4, bf16 2e-2) and by
   error over the plain output's largest magnitude (fp32 1e-3, bf16 1e-2);
   the den of the fused forward only by the latter;
4. kernels on the main path's operands: block 0's own q, k, v of the model
   at pde_40k (B=8, N=40,000) and pde_1m (B=1, N=1,048,576), fp32, every
   batch element and head, the plain versions run a head at a time. Each
   output must also reject a plain version with one token tile (encode) or
   latent tile (decode) left out, so the limits are shown to bite. Times by
   CUDA events of the kernel, the plain version and one
   ``F.scaled_dot_product_attention`` yardstick per SDPA call, at both
   shapes (the JSON line carries pde_40k's);
5. the slice end to end: ``get_model(flare_pde)`` from a seed, whose infer
   plan must be ``packed``; point-cloud requests at pde_40k and one pde_1m
   forward, with launch counts zeroed just before and read just after; the
   same requests under policy ``pallas`` (the encode and decode kernels);
   both kernel paths held against the plain ``sdpa`` path on all 8 batch
   elements of pde_40k (abs and rel 1e-3 after 8 blocks);
6. one JSON line of per-kernel numbers, then the card's name and power limit,
   then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth. Every bound is against these.
PEAK_FP32 = 67e12
PEAK_BW = 3.35e12

SEED = 0
# bf16 and ragged edges, on random operands (the model itself runs fp32)
SMALL = {"bf16 full width": dict(b=1, h=8, m=2048, n=40000, d=8),
         "ragged": dict(b=2, h=4, m=16, n=97, d=8)}
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}   # absolute: max |kernel - plain|
# relative: max |kernel - plain| / max |plain|. A kernel that dropped one
# token tile (encode) or one latent tile (decode) must fail it: the script
# measures that on the main path's operands and raises if it would pass.
RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
TILE = 256    # tokens per encode tile and latents per decode tile (csrc/flare.cu, D=8)
PATH_TOL = 1e-3   # the kernel paths against the plain path after 8 blocks, abs and rel
SOURCE = "src/repro_torch/csrc/flare.cu"
REPLACES = {
    "flare_encode": "src/repro/kernels/flare.py:48",
    "flare_decode": "src/repro/kernels/flare.py:150",
    "flare_fused_fwd": "src/repro/kernels/flare_packed.py:162",
}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(log: str) -> list:
    """One line per D=8 kernel: registers, shared memory, spills."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers(.*)", line)) and name and "Li8E" in name:
            kind = next(k for k in ("encode", "decode", "combine") if k in name)
            rows.append(f"  {kind:<8} {name[:60]:<60} {m.group(1)} regs{m.group(2)} {spill}")
    return rows


def inputs(s: dict, dtype, gen, device):
    """q [H, M, D]; k, v [B, H, N, D] as the strided views the model gives."""
    import torch

    q = torch.randn(s["h"], s["m"], s["d"], generator=gen) * s["d"] ** -0.5
    k = torch.randn(s["b"], s["n"], s["h"], s["d"], generator=gen)
    v = torch.randn(s["b"], s["n"], s["h"], s["d"], generator=gen)
    return (q.to(device, dtype), k.to(device, dtype).transpose(1, 2),
            v.to(device, dtype).transpose(1, 2))


def mixer_operands(net, x):
    """q, k, v as block 0's mixer receives them for input x: the main path's
    own operands, k and v as strided split-head views."""
    import torch

    from repro_torch.nn.modules import layernorm, resmlp

    with torch.no_grad():
        blk = net.blocks[0]
        h = layernorm(blk.ln1, resmlp(net.in_proj, x))
        q = blk.mixer.q_latent.detach()
        heads = lambda t: t.unflatten(2, (q.shape[0], -1)).transpose(1, 2)
        return q, heads(resmlp(blk.mixer.k_proj, h)), heads(resmlp(blk.mixer.v_proj, h))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def by_head(fn, q, *xs):
    """A plain version run one head at a time (its [B, M, N] scores must fit
    the card), outputs concatenated over heads."""
    import torch

    outs = [fn(q[i:i + 1], *(x[:, i:i + 1] for x in xs)) for i in range(q.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


class Checks:
    """Kernel outputs held against their plain versions; every comparison is
    printed with the plain output's scale, and a failure raises only after
    the whole phase has printed."""

    def __init__(self):
        self.failures, self.max_abs = [], {name: 0.0 for name in REPLACES}

    def hold(self, name, what, got, want, dtype, dropped=None, fp32_plain=None):
        """``want``: the plain version on the same inputs, in the kernel's
        dtype or (with ``fp32_plain``, the plain version's fp32 output) in
        fp64. ``dropped``: the fp64 plain version with one tile left out, the
        output of a kernel that lost a tile; the relative limit must reject it."""
        key = str(dtype).removeprefix("torch.")
        label = f"{name} {what}"
        like = want if fp32_plain is None else fp32_plain
        if got.shape != like.shape or got.dtype != like.dtype:
            self.failures.append(f"{label}: {tuple(got.shape)}/{got.dtype} vs plain "
                                 f"{tuple(like.shape)}/{like.dtype}")
            return
        err, scale = max_err(got, want), want.abs().max().item()
        rel = err / scale
        # den is a sum of up to N terms: held relative to its size only
        ok = math.isfinite(err) and rel <= RTOL[key] and (what.startswith("den")
                                                          or err <= ATOL[key])
        line = (f"  {label:<22} max|plain| {scale:.4g}  abs err {err:.3g} (atol "
                f"{ATOL[key]:g})  rel {rel:.3g} (rtol {RTOL[key]:g})")
        if fp32_plain is not None:
            line += f"  [fp32 plain: rel {max_err(fp32_plain, want) / scale:.3g}]"
        if dropped is not None:
            rel_drop = max_err(dropped, want) / scale
            line += f"  one tile dropped: rel {rel_drop:.3g}"
            if not rel_drop > RTOL[key]:
                self.failures.append(f"{label}: rtol {RTOL[key]} would pass a kernel that "
                                     f"dropped a tile (rel {rel_drop:.3g})")
        print(line + ("" if ok else "  FAILED"), flush=True)
        if not ok:
            self.failures.append(f"{label}: abs {err:.3g}, rel {rel:.3g}")
        if key == "float32" and what[0] in "yz":
            self.max_abs[name] = max(self.max_abs[name], err)

    def raise_failures(self, phase):
        if self.failures:
            raise AssertionError(f"{phase}: " + "; ".join(self.failures))


def check_small(checks: Checks, device) -> None:
    """Every kernel against its plain version on random operands: bf16 at
    the full width, and ragged edges (M=16, N=97) in both dtypes."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    gen = torch.Generator().manual_seed(SEED)
    for shape_name, s in SMALL.items():
        for dtype in ((torch.bfloat16,) if shape_name.startswith("bf16")
                      else (torch.float32, torch.bfloat16)):
            q, k, v = inputs(s, dtype, gen, device)
            print(f"kernels {shape_name} {s} {dtype}:", flush=True)
            z_ref = ref.flare_encode_ref(q, k, v)
            checks.hold("flare_encode", "z", flare_encode(q, k, v), z_ref, dtype)
            checks.hold("flare_decode", "y", flare_decode(q, k, z_ref),
                        ref.flare_decode_ref(q, k, z_ref), dtype)
            for what, got, want in zip(("y", "z", "max", "den"), flare_fused_fwd(q, k, v),
                                       ref.flare_fused_fwd_ref(q, k, v)):
                checks.hold("flare_fused_fwd", what, got, want, dtype)
    checks.raise_failures("kernels on random operands")


def check_main(checks: Checks, label: str, q, k, v) -> None:
    """Every kernel on block 0's own operands of a main-path shape, every
    batch element and head, against the plain version on the same inputs
    in fp64 (the fp32 plain version is itself a sum over N tokens, off fp64
    by more than the kernels are: its error is printed beside). The plain
    versions run a head at a time. Each output must also reject the fp64
    plain version with one token tile (encode) or latent tile (decode) left
    out."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    b, h, n, d = k.shape
    print(f"kernels {label} (block 0's operands, B={b} H={h} M={q.shape[1]} N={n} D={d} "
          f"fp32, k/v strides {k.stride()}; held against the plain version in fp64):",
          flush=True)
    f32 = torch.float32
    q64, k64, v64 = (t.to(torch.float64) for t in (q, k, v))
    drop_tokens = lambda fn: lambda qh, kh, vh: fn(qh, kh[:, :, TILE:], vh[:, :, TILE:])
    drop_latents = lambda qh, kh, zh: ref.flare_decode_ref(qh[:, TILE:], kh, zh[:, :, TILE:])

    z32 = by_head(ref.flare_encode_ref, q, k, v)
    z64 = by_head(ref.flare_encode_ref, q64, k64, v64)
    z64_drop = by_head(drop_tokens(ref.flare_encode_ref), q64, k64, v64)
    checks.hold("flare_encode", "z", flare_encode(q, k, v), z64, f32,
                dropped=z64_drop, fp32_plain=z32)
    y32 = by_head(ref.flare_decode_ref, q, k, z32)
    zz = z32.to(torch.float64)   # the decode's input, the same for every version
    checks.hold("flare_decode", "y", flare_decode(q, k, z32), by_head(ref.flare_decode_ref, q64, k64, zz),
                f32, dropped=by_head(drop_latents, q64, k64, zz), fp32_plain=y32)
    del y32, zz
    got = flare_fused_fwd(q, k, v)
    plain32 = by_head(ref.flare_fused_fwd_ref, q, k, v)
    want = by_head(ref.flare_fused_fwd_ref, q64, k64, v64)
    drops = {"y": by_head(ref.flare_decode_ref, q64, k64, z64_drop), "z": z64_drop}
    for what, g, w, p32 in zip(("y", "z", "max", "den"), got, want, plain32):
        checks.hold("flare_fused_fwd", what, g, w, f32, dropped=drops.get(what), fp32_plain=p32)
    checks.raise_failures(f"kernels at {label}")


def time_kernels(q, k, v) -> dict:
    """CUDA-event times of each kernel, its plain version (a head at a time)
    and the SDPA yardstick on the same operands, with the bound of the work."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flare import flare_decode, flare_encode
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    b, h, n, d = k.shape
    m = q.shape[1]
    z = flare_encode(q, k, v)
    qb = q.expand(b, h, m, d)
    sdpa = lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, scale=1.0)
    runs = {
        "flare_encode": (lambda: flare_encode(q, k, v),
                         lambda: by_head(ref.flare_encode_ref, q, k, v),
                         lambda: sdpa(qb, k, v)),
        "flare_decode": (lambda: flare_decode(q, k, z),
                         lambda: by_head(ref.flare_decode_ref, q, k, z),
                         lambda: sdpa(k, qb, z)),
        "flare_fused_fwd": (lambda: flare_fused_fwd(q, k, v),
                            lambda: by_head(ref.flare_fused_fwd_ref, q, k, v),
                            lambda: sdpa(k, qb, sdpa(qb, k, v))),
    }
    f4, mnd = 4, b * h * m * n * d
    qkv = f4 * (h * m * d + 2 * b * h * n * d)
    work = {   # (FLOP, bytes): each input read once, each output written once
        "flare_encode": (2 * 2 * mnd, qkv + f4 * b * h * m * d),
        "flare_decode": (2 * 2 * mnd, qkv + f4 * b * h * m * d),
        # the scores are needed once: three products
        "flare_fused_fwd": (3 * 2 * mnd, qkv + f4 * (b * h * n * d + b * h * m * (d + 2))),
    }
    stats = {}
    for name, (kern, plain, lib) in runs.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BW * 1e3
        stats[name] = dict(
            ms=cuda_ms(kern, reps=10), plain_ms=cuda_ms(plain, reps=2),
            library_ms=cuda_ms(lib, reps=5), bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    return stats


def forward_ms(model, net, batch, reps: int):
    """Host clock around synchronized forwards after one warm-up; also the
    peak device memory of one forward."""
    import torch

    out = model.forward(net, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = model.forward(net, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return out, ms, torch.cuda.max_memory_allocated() / 2**30


def check_output(name: str, out, batch) -> float:
    from repro_torch.models.pde import relative_l2

    want = tuple(batch["y"].shape)
    if tuple(out.shape) != want:
        raise AssertionError(f"{name}: output {tuple(out.shape)}, expected {want}")
    if not bool(out.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    rel = relative_l2(out, batch["y"]).item()
    if not math.isfinite(rel):
        raise AssertionError(f"{name}: rel-L2 {rel}")
    return rel


def breakdown(model, net, batch, label: str) -> None:
    """Device time of one forward by kernel name (torch.profiler), and the
    device's busy share of the forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model.forward(net, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward(net, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    total = sum(ms for _, ms, _ in rows)
    if total == 0:
        print(f"breakdown {label}: the profiler recorded no device time (not measured)")
        return
    print(f"breakdown {label}: wall {wall_ms:.3f} ms, device busy {total:.3f} ms "
          f"({100 * total / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {100 * ms / total:5.1f}%  {ms:9.3f} ms  x{count:<4d} {key[:90]}")


def drive(model, net, batches: dict, label: str) -> dict:
    """One counted window: launch counts zeroed just before, read just after."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    outs = {}
    for shape, (batch, reps) in batches.items():
        out, ms, peak = forward_ms(model, net, batch, reps)
        rel = check_output(f"{label} {shape}", out, batch)
        outs[shape] = out
        b, n = batch["x"].shape[:2]
        print(f"path {label} {shape} B={b} N={n}: {ms:.3f} ms/forward, peak {peak:.2f} GiB, "
              f"rel-L2 vs target {rel:.4f}", flush=True)
    counts = launch_counts()
    print(f"path {label} launches: {counts}", flush=True)
    return {"counts": counts, "outs": outs}


def main() -> int:
    if not (SRC / "repro_torch" / "csrc" / "flare.cu").is_file():
        print("chip_smoke.py: run it from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = gpu_line()
    print(f"gpu: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")
    print("\n".join(ptxas_summary(_build.build_log)), flush=True)

    checks = Checks()
    check_small(checks, device)

    from repro_torch.configs import get_config
    from repro_torch.config import SHAPES
    from repro_torch.core.policy import MixerPolicy
    from repro_torch.data.pde_data import darcy_batch, pointcloud_batch
    from repro_torch.models.api import get_model

    cfg = get_config("flare_pde")
    model = get_model(cfg)
    plan = model.plans["infer"].describe()
    print(f"model {cfg.name}: plans {{infer: {plan}, train: {model.plans['train'].describe()}"
          " (training runs on plain torch until the backward kernel lands)}}", flush=True)
    if plan != "packed":
        raise AssertionError(f"infer plan {plan} is not the fused kernel")
    net = model.init(SEED)
    s40, s1m = SHAPES["pde_40k"], SHAPES["pde_1m"]
    t0 = time.perf_counter()
    b40 = pointcloud_batch(SEED, 0, s40.global_batch, grid=256, num_points=s40.seq_len)
    b1m = darcy_batch(SEED, 1, s1m.global_batch, grid=int(math.isqrt(s1m.seq_len)))
    torch.cuda.synchronize()
    print(f"data: pde_40k {tuple(b40['x'].shape)}, pde_1m {tuple(b1m['x'].shape)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # each kernel on the operands the main path gives it, at both shapes
    ops40 = mixer_operands(net, b40["x"])
    check_main(checks, "pde_40k", *ops40)
    stats = time_kernels(*ops40)
    for name, st in stats.items():
        print(f"time {name} pde_40k fp32: {st}", flush=True)
    del ops40
    ops1m = mixer_operands(net, b1m["x"])
    check_main(checks, "pde_1m", *ops1m)
    for name, st in time_kernels(*ops1m).items():
        print(f"time {name} pde_1m fp32: {st}", flush=True)
    del ops1m
    torch.cuda.empty_cache()

    packed = drive(model, net, {"pde_40k": (b40, 3), "pde_1m": (b1m, 2)}, "packed")
    pallas_model = get_model(cfg, policy=MixerPolicy(backends=("pallas",)))
    pallas = drive(pallas_model, net, {"pde_40k": (b40, 3)}, "pallas")
    breakdown(model, net, b40, "packed pde_40k")
    breakdown(model, net, b1m, "packed pde_1m")
    c_pk, c_pl = packed["counts"], pallas["counts"]
    if not (c_pk["flare_fused_fwd"] > 0 and c_pk["flare_encode"] == c_pk["flare_decode"] == 0):
        raise AssertionError(f"packed path launches {c_pk}")
    if not (c_pl["flare_encode"] > 0 and c_pl["flare_decode"] > 0 and c_pl["flare_fused_fwd"] == 0):
        raise AssertionError(f"pallas path launches {c_pl}")
    for name in stats:
        stats[name]["launches"] = c_pk[name] + c_pl[name]
        stats[name]["max_abs_err"] = checks.max_abs[name]

    # the kernel paths against the plain path on the same weights, every
    # batch element (the plain path runs one at a time: its scores are
    # [H, M, N] per element)
    plain_model = get_model(cfg, policy=MixerPolicy(backends=("sdpa",)))
    y_plain = torch.cat([plain_model.forward(net, {"x": b40["x"][i:i + 1]})
                         for i in range(s40.global_batch)])
    scale = y_plain.abs().max().item()
    for label, out in (("packed", packed["outs"]["pde_40k"]), ("pallas", pallas["outs"]["pde_40k"])):
        err = max_err(out, y_plain)
        print(f"path {label} vs sdpa at B={s40.global_batch} N={s40.seq_len} over "
              f"{cfg.num_layers} blocks: max|plain| {scale:.4g}, max abs err {err:.3g} "
              f"(atol {PATH_TOL}), rel {err / scale:.3g} (rtol {PATH_TOL})", flush=True)
        if not (err <= PATH_TOL and err / scale <= PATH_TOL):
            raise AssertionError(f"{label} path differs from the plain path by {err}")

    rows = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
             **{key: stats[name][key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")}}
            for name in REPLACES]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
