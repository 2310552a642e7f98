"""FLARE encode and decode: CUDA kernels for Hopper with their plain versions.

Counterparts of ``repro/kernels/flare.py``:

* :func:`flare_encode` replaces ``_encode_kernel`` / ``flare_encode_pallas``:
  Z = softmax(q k^T) v over tokens, an online softmax per latent row.
* :func:`flare_decode` replaces ``_decode_kernel`` / ``flare_decode_pallas``:
  Y = softmax over latents of (k q^T), applied to Z.

The kernels are in ``csrc/flare.cu`` (TF32 tensor cores, each fp32 operand
split in two parts), whose head comment says what bounds them on an H100 and
what their design does about it. Each
wrapper takes q ``[H, M, D]`` with k/v ``[B, H, N, D]`` in any strides with
a unit D stride (the model's split-head views go in without a copy). On a CPU tensor it runs the plain version in ``kernels/ref.py``; on a
CUDA tensor it launches the kernel or raises.

Two launch parameters, the counterparts of the TPU kernels' tiles, are the
caller's (``None``: the default below, what the kernels launched before
they were tunable): ``block_m``, a block's rows (the encode's latents, the
decode's tokens), one of :func:`row_choices` for the head dim; and
``block_n``, the encode's tokens a split, so that N runs in
ceil(N / block_n) splits (at most :data:`MAX_SPLITS`). The plans of
``backends/autotune.py`` carry them. On CPU tensors they are checked and
ignored: the plain versions have no tiles. Each counts its launches in
``<wrapper>.launches``. These wrappers are forward-only: a call that
autograd would record raises. Autograd runs through the fused kernels'
``FlareFused`` function (``kernels/flare_packed.py``, the ``packed``
backend), whose backward is a kernel too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flare_decode_ref, flare_encode_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims csrc/flare.cu and csrc/flare_bwd.cu take: any D from 1 to 64,
# run at the MMA width 8, 16, 32 or 64 above it (flare_mma.cuh::at_mma_width)
HEAD_DIMS = range(1, 65)
MAX_GROUPS = 65535   # B*H rides on gridDim.y


PACKED_GRADS = ("the 'packed' backend (FlareFused in kernels/flare_packed.py), whose "
                "backward is the fused kernel")


def forbid_grad(name: str, *ts: torch.Tensor, grads_via: str = PACKED_GRADS) -> None:
    """Raise if autograd would record a call of the forward-only kernel
    ``name``; ``grads_via`` names the path that differentiates instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} is forward-only: run it under torch.no_grad(), or "
                           f"differentiate through {grads_via}")


def on_cuda(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on any
    other device."""
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    kind = ts[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {kind!r}")
    return kind == "cuda"


def check_operands(name: str, q: torch.Tensor, *xs: torch.Tensor) -> None:
    """q [H, M, D] and per-head [B, H, N, D] operands the kernels accept."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [H, M, D], got {tuple(q.shape)}")
    h, m, d = q.shape
    for x in xs:
        if x.dim() != 4 or x.shape[1] != h or x.shape[3] != d:
            raise ValueError(f"{name}: expected [B, {h}, N, {d}], got {tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name}: dtype {x.dtype} differs from q's {q.dtype}")
    b, n = xs[0].shape[0], xs[0].shape[2]
    if any(x.shape[0] != b or x.shape[2] != n for x in xs):
        raise ValueError(f"{name}: operand shapes differ: {[tuple(x.shape) for x in xs]}")
    if m == 0 or n == 0 or b == 0:
        raise ValueError(f"{name}: empty problem (B={b}, M={m}, N={n})")


def check_kernel_operands(name: str, q: torch.Tensor, *xs: torch.Tensor,
                          head_dims=HEAD_DIMS) -> None:
    """What the CUDA kernels take beyond :func:`check_operands`; ``head_dims``
    are those the kernel is built for."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {list(DTYPE_CODES)}")
    if q.shape[2] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[2]} not in {head_dims}")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    for x in xs:
        if x.stride(3) != 1:
            raise ValueError(f"{name}: operand strides {x.stride()} need a unit D stride")
    if xs[0].shape[0] * q.shape[0] > MAX_GROUPS:
        raise ValueError(f"{name}: B*H above {MAX_GROUPS}")


def heads_out(b: int, h: int, n: int, d: int, dtype, device) -> torch.Tensor:
    """[B, H, N, D] output laid out as [B, N, H, D], so merging heads back to
    [B, N, H*D] is a view."""
    return torch.empty((b, n, h, d), dtype=dtype, device=device).permute(0, 2, 1, 3)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---- launch geometry (csrc/flare.cu) ----------------------------------------
ROW_WARPS = 4          # MMA_WARPS: a block's warps, 16 rows a tile each
WAVE_BLOCKS = 4        # blocks resident an SM, for the default split
MIN_SPLIT_TOKENS = 1024
MAX_SPLITS = 65535     # the splits ride on gridDim.z
# the 16-row tiles a warp built at each MMA width (csrc/flare.cu::at_row_tiles),
# the default (row_tiles<D>()) first
ROW_TILES = {8: (4, 2, 1), 16: (2, 1), 32: (1,), 64: (1,)}


def mma_width(d: int) -> int:
    """The MMA width a head dim runs at (flare_mma.cuh::at_mma_width)."""
    return 8 if d <= 8 else 16 if d <= 16 else 32 if d <= 32 else 64


def row_choices(d: int) -> tuple:
    """The rows a block (``block_m``) the encode and decode are built for at
    head dim ``d``, the default first."""
    return tuple(16 * ROW_WARPS * t for t in ROW_TILES[mma_width(d)])


def default_rows(d: int) -> int:
    """``block_m`` by default: 16 * 4 * row_tiles<D>() (256 at D <= 8, 128 up
    to 16, 64 above)."""
    return row_choices(d)[0]


def default_splits(groups: int, m: int, n: int, sms: int) -> int:
    """The default token splits of the per-latent kernels (the encode, and
    the backward's passes a and c) for ``groups`` = B*H on ``sms``
    multiprocessors: enough blocks of 256 latent rows for WAVE_BLOCKS an SM,
    each split keeping at least 1,024 tokens (``flare_encode_splits`` in
    ``csrc/flare.cu``, the same rule)."""
    blocks = groups * -(-m // (16 * ROW_WARPS * ROW_TILES[8][0]))
    return max(1, min(sms * WAVE_BLOCKS // blocks, n // MIN_SPLIT_TOKENS))


def card_sms(device) -> int:
    """The multiprocessors of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_tiles(name: str, d: int, n: int, block_m: Optional[int] = None,
                block_n: Optional[int] = None) -> None:
    """Raise unless ``block_m`` is a built row tile at head dim ``d`` and
    ``block_n`` gives 1 to MAX_SPLITS splits of ``n`` tokens (None passes)."""
    if block_m is not None and block_m not in row_choices(d):
        raise ValueError(f"{name}: block_m={block_m} is not built at D={d}; "
                         f"choose from {row_choices(d)}")
    if block_n is not None and (int(block_n) != block_n or block_n < 1
                                or -(-n // int(block_n)) > MAX_SPLITS):
        raise ValueError(f"{name}: block_n={block_n} must be a positive token count giving "
                         f"at most {MAX_SPLITS} splits of N={n}")


def encode_splits(k: torch.Tensor, m: int, block_n: Optional[int] = None) -> int:
    """The token splits of the per-latent kernels (the encode, and the
    backward's passes a and c) for k [B, H, N, D] on its card: ceil(N /
    block_n), or by default :func:`default_splits`."""
    b, h, n, _ = k.shape
    if block_n is not None:
        return -(-n // int(block_n))
    return default_splits(b * h, m, n, card_sms(k.device))


def encode_into(q, k, v, z, mx=None, den=None, *, raw: bool = False,
                block_m: Optional[int] = None, block_n: Optional[int] = None) -> None:
    """Launch the encode (and, when N is split, its combine) into ``z``
    [B, H, M, D] (v's dtype or fp32), and the per-latent max and den into
    ``mx``/``den`` [B, H, M] fp32 when given. ``raw``: z fp32 receives the
    numerator before the normalisation (mx and den required), the
    statistics a rank of a sharded mixer merges. Operands and launch
    parameters already checked."""
    b, h, n, d = k.shape
    m = q.shape[1]
    lib = _build.lib()
    splits = encode_splits(k, m, block_n)
    part = (torch.empty(splits * b * h * m * (d + 2), dtype=torch.float32, device=k.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    rows = default_rows(d) if block_m is None else block_m
    common = (b, h, m, n, d, *k.stride()[:3], *v.stride()[:3], splits, rows,
              DTYPE_CODES[q.dtype])
    if raw:
        err = lib.flare_enc_stats(ptr(q), ptr(k), ptr(v), ptr(z), ptr(mx), ptr(den), ptr(part),
                                  *common, stream)
    else:
        err = lib.flare_encode(ptr(q), ptr(k), ptr(v), ptr(z), ptr(mx), ptr(den), ptr(part),
                               *common, DTYPE_CODES[z.dtype], stream)
    _build.check(err, "flare_enc_stats" if raw else "flare_encode")


def decode_into(q, k, z, y, lse=None, *, block_m: Optional[int] = None) -> None:
    """Launch the decode of ``z`` into ``y`` [B, H, N, D] (any strides with a
    unit D stride), and each token's log-sum-exp over the latents into
    ``lse`` [B, H, N] fp32 when given. Operands and ``block_m`` already
    checked."""
    b, h, n, d = k.shape
    err = _build.lib().flare_decode(
        ptr(q), ptr(k), ptr(z), ptr(y), ptr(lse), b, h, q.shape[1], n, d,
        *k.stride()[:3], *y.stride()[:3], default_rows(d) if block_m is None else block_m,
        DTYPE_CODES[k.dtype], DTYPE_CODES[z.dtype],
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "flare_decode")


def flare_encode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 block_m: Optional[int] = None, block_n: Optional[int] = None) -> torch.Tensor:
    """Z = softmax(q k^T) v, scale 1: q [H, M, D], k/v [B, H, N, D] ->
    Z [B, H, M, D] in v's dtype."""
    forbid_grad("flare_encode", q, k, v)
    check_operands("flare_encode", q, k, v)
    check_tiles("flare_encode", k.shape[3], k.shape[2], block_m, block_n)
    if not on_cuda("flare_encode", q, k, v):
        return flare_encode_ref(q, k, v)
    check_kernel_operands("flare_encode", q, k, v)
    b, h, _, d = k.shape
    z = torch.empty((b, h, q.shape[1], d), dtype=v.dtype, device=v.device)
    encode_into(q, k, v, z, block_m=block_m, block_n=block_n)
    flare_encode.launches += 1
    return z


flare_encode.launches = 0


def flare_decode(q: torch.Tensor, k: torch.Tensor, z: torch.Tensor, *,
                 block_m: Optional[int] = None) -> torch.Tensor:
    """Y = softmax over latents of (k q^T), applied to z: q [H, M, D],
    k [B, H, N, D], z [B, H, M, D] -> Y [B, H, N, D] in k's dtype. z may be
    k's dtype or fp32."""
    forbid_grad("flare_decode", q, k, z)
    check_operands("flare_decode", q, k)
    b, h, n, d = k.shape
    m = q.shape[1]
    if tuple(z.shape) != (b, h, m, d):
        raise ValueError(f"flare_decode: z must be [{b}, {h}, {m}, {d}], got {tuple(z.shape)}")
    check_tiles("flare_decode", d, n, block_m)
    if not on_cuda("flare_decode", q, k, z):
        return flare_decode_ref(q, k, z)
    check_kernel_operands("flare_decode", q, k)
    if z.dtype not in (k.dtype, torch.float32) or not z.is_contiguous():
        raise ValueError(f"flare_decode: z must be contiguous {k.dtype} or float32")
    y = heads_out(b, h, n, d, k.dtype, k.device)
    decode_into(q, k, z, y, block_m=block_m)
    flare_decode.launches += 1
    return y


flare_decode.launches = 0
