"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (the fixture
decides, at run time). Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 1e-4 (sums in another order over up to 40,000 terms),
bf16 2e-2; against the plain version in fp64, 1e-5 of the output's largest
magnitude. The fused backward is held against its plain version in fp64 at
1e-5 of each gradient's largest magnitude in fp32 (its kernels sit near
1e-6 there), and at 2e-2 in bf16. The tensor-core forward (encode,
decode, fused, the raw statistics) is held in fp32 against fp64 at 1e-5 of
max |out|, a limit shown to reject one of its own tiles left out. The
causal kernel is held against its plain version in fp64 at 1e-5 of max |y|
in fp32, and against the plain version on the same bf16 inputs at 2e-2 in
bf16; its tensor-core route also beyond bf16's output rounding against
fp64, max(|y - want| - 2^-8 |want|) within 1e-5 of max |want|, a limit that
rejects a lost state tile, with equal bits on two calls. The paged-attention kernel
is held against its plain version in fp64 at 1e-5 of max |o| where it
computes in fp32 (fp32 queries, any pages; MLA's read at DeepSeek-V2-Lite's
and MiniCPM3's shapes on the MLA instance too), and at 1e-2 where it rounds the
weights to bf16 (bf16 queries over bf16 pages); the smoke qwen2's engine
gives the same greedy tokens through the kernel route as through the
gather route, and the smoke Zamba2's kernel route (one read a shared
invocation) the gather route's and the dense pool's; the serving engine's
decode step, captured as one CUDA graph and replayed, gives the eager
step's greedy tokens (fp32 compute) for gqa (dense, gather, kernel),
``flare_lm``, the smoke DeepSeek-V2-Lite, RWKV-6 (dense) and Zamba2 (dense,
kernel), its
replays draw fresh noise and repeat with a seed, and the launch counters
count each replay. The flash-attention kernel is held against its plain version
in fp64 at 1e-5 of max |o| in fp32, and against the plain version on the
same bf16 inputs at 1e-2 of max |o| in bf16 (the kernels keep the weights
in fp32, or split in two bf16 or TF32 parts, where the plain version rounds
them to bf16); on both bf16 routes (tensor cores and CUDA cores) bf16 is also held
against the plain version in fp64 beyond bf16's output rounding,
max(|o - want| - 2^-8 |want|) within 1e-5 of max |want|; the smoke qwen2's
prefill through it agrees with the chunked route within 1e-4 of max |logit|
in fp32 compute, and the smoke seamless-m4t's prefill through it (and the
fused FLARE kernel, for the FLARE encoder) with the plain route."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pde_data import pointcloud_batch
from repro_torch.kernels import ref
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import MixerPolicy
from repro_torch.kernels.flare import flare_decode, flare_encode
from repro_torch.kernels.flare_causal import flare_causal_chunk
from repro_torch.kernels.flare_packed import FlareFused, flare_fused_bwd, flare_fused_fwd
from repro_torch.kernels.flare_packed_shard import (
    combine_stats,
    flare_enc_stats,
    flare_shard_decode,
    flare_shard_dz,
    flare_shard_grads,
)
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.api import get_model
from repro_torch.nn.modules import layernorm, resmlp

pytestmark = pytest.mark.gpu

# (B, H, M, N, D): D 4 and 8 (the paper's, instances of their own), then the
# padded widths and the head dims between them (any other D from 1 to 64
# runs at the next of 4, 8, 16, 32, 64, its lanes beyond D zero)
SHAPES = [(2, 4, 16, 97, 8), (1, 8, 2048, 4099, 8), (2, 3, 24, 300, 4), (1, 2, 64, 3000, 4),
          (2, 3, 24, 300, 3), (1, 2, 40, 500, 12), (2, 2, 64, 1000, 16), (1, 2, 33, 700, 24),
          (1, 2, 128, 2000, 32), (1, 2, 96, 1500, 64), (1, 2, 16, 97, 1), (2, 3, 24, 300, 6)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def _inputs(shape, dtype, device, seed=0):
    b, h, m, n, d = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(h, m, d, generator=g) * d ** -0.5
    k = torch.randn(b, n, h, d, generator=g).transpose(1, 2)   # the model's split-head view
    v = torch.randn(b, n, h, d, generator=g).transpose(1, 2)
    return q.to(device, dtype), k.to(device, dtype), v.to(device, dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape, dtype):
    q, k, v = _inputs(shape, dtype, cuda)
    before = launch_counts()
    z_ref = ref.flare_encode_ref(q, k, v)
    torch.testing.assert_close(flare_encode(q, k, v), z_ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(flare_decode(q, k, z_ref), ref.flare_decode_ref(q, k, z_ref),
                               atol=TOL[dtype], rtol=TOL[dtype])
    y, z, mx, den, lse = flare_fused_fwd(q, k, v)
    y_ref, z_ref32, mx_ref, den_ref, lse_ref = ref.flare_fused_fwd_ref(q, k, v)
    torch.testing.assert_close(y, y_ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(z, z_ref32, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(mx, mx_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(den, den_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    after = launch_counts()
    assert all(after[name] == before[name]
               + (name in ("flare_encode", "flare_decode", "flare_fused_fwd"))
               for name in after)


def test_model_operands_stay_near_fp64(cuda):
    """Block 0's q, k, v of the paper-scale surrogate on a pde_40k batch
    (spatially ordered tokens, a flat softmax): the kernels' fp32 outputs
    stay within 1e-5 of max |out| of the plain version in fp64, where the
    fp32 plain version does not. Two heads are held, all batch elements."""
    cfg = get_config("flare_pde")
    net = get_model(cfg, device=cuda).init(0)
    x = pointcloud_batch(0, 0, 8, grid=256, num_points=40000, device=cuda)["x"]
    with torch.no_grad():
        blk = net.blocks[0]
        hid = layernorm(blk.ln1, resmlp(net.in_proj, x))
        q = blk.mixer.q_latent.detach()
        heads = lambda t: t.unflatten(2, (q.shape[0], -1)).transpose(1, 2)
        k, v = heads(resmlp(blk.mixer.k_proj, hid)), heads(resmlp(blk.mixer.v_proj, hid))
    y, z, _, _, _ = flare_fused_fwd(q, k, v)
    q64, k64, v64 = q[:2].double(), k[:, :2].double(), v[:, :2].double()
    z64 = ref.flare_encode_ref(q64, k64, v64)
    y64 = ref.flare_decode_ref(q64, k64, z64)
    for got, want in ((flare_encode(q, k, v), z64), (z, z64), (y, y64),
                      (flare_decode(q, k, z), ref.flare_decode_ref(q64, k64, z[:, :2].double()))):
        assert (got[:, :2].double() - want).abs().max() <= 1e-5 * want.abs().max()


def _fwd_tile(d: int) -> int:
    """Columns a staged tile of the forward kernels (csrc/flare.cu): 256 at
    the MMA width 8, halved at each wider one."""
    width = max(8, 1 << (d - 1).bit_length())
    return 256 * 8 // width


# the tensor-core forward: D 1, 3, 4 (at width 8), the paper's 8 (its own
# instance), 16, 24 (at 32), 64; ragged N and M; the N-split at pde_1m's
# geometry (B*H = 8, M = 2048: eight splits)
FWD_TC_SHAPES = [(2, 3, 24, 300, 1), (2, 3, 40, 700, 3), (1, 2, 70, 1000, 4),
                 (2, 4, 300, 1500, 8), (1, 2, 96, 1100, 16), (1, 2, 33, 700, 24),
                 (1, 2, 96, 1500, 64), (1, 8, 2048, 65536, 8)]


@pytest.mark.parametrize("shape", FWD_TC_SHAPES)
def test_forward_tensor_cores_near_fp64(cuda, shape):
    """fp32: the encode, the decode (of the kernel's own z) and the fused
    forward's y against the plain version in fp64 at 1e-5 of max |.|, each
    limit rejecting the fp64 plain version with the kernel's first token
    tile (encode) or latent tile (decode) left out; the raw statistics of
    flare_enc_stats against their fp64 plain version; bf16 against the
    plain version on the same operands."""
    q, k, v = _inputs(shape, torch.float32, cuda)
    _, _, m, n, d = shape
    tn, tm = min(_fwd_tile(d), n // 2), min(_fwd_tile(d), m // 2)   # no more than a tile
    wide = [t.double() for t in (q, k, v)]
    z64 = ref.flare_encode_ref(*wide)
    z = flare_encode(q, k, v)
    lost = ref.flare_encode_ref(wide[0], wide[1][:, :, tn:], wide[2][:, :, tn:])
    assert _max_rel(z, z64) <= 1e-5 < _max_rel(lost, z64)
    y64 = ref.flare_decode_ref(wide[0], wide[1], z.double())
    lost = ref.flare_decode_ref(wide[0][:, tm:], wide[1], z.double()[:, :, tm:])
    assert _max_rel(flare_decode(q, k, z), y64) <= 1e-5 < _max_rel(lost, y64)
    y, zf, mx, den, lse = flare_fused_fwd(q, k, v)
    for got, want in zip((y, zf, mx, den, lse), ref.flare_fused_fwd_ref(*wide)):
        assert _max_rel(got, want) <= 1e-5
    for got, want in zip(flare_enc_stats(q, k, v), ref.flare_enc_stats_ref(*wide)):
        assert got.dtype == torch.float32 and _max_rel(got, want) <= 1e-5
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    zb = flare_encode(qb, kb, vb)
    torch.testing.assert_close(zb, ref.flare_encode_ref(qb, kb, vb), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(flare_decode(qb, kb, zb), ref.flare_decode_ref(qb, kb, zb),
                               atol=2e-2, rtol=2e-2)


def test_contiguous_operands_and_fp32_z(cuda):
    q, k, v = _inputs((2, 4, 16, 97, 8), torch.bfloat16, cuda)
    kc, vc = k.contiguous(), v.contiguous()
    torch.testing.assert_close(flare_encode(q, kc, vc), ref.flare_encode_ref(q, kc, vc),
                               atol=2e-2, rtol=2e-2)
    z32 = ref.flare_encode_ref(q.float(), kc.float(), vc.float())
    torch.testing.assert_close(flare_decode(q, kc, z32), ref.flare_decode_ref(q, kc, z32),
                               atol=2e-2, rtol=2e-2)


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _inputs((1, 2, 16, 33, 65), torch.float32, cuda)     # D above 64 is not built
    with pytest.raises(ValueError, match="head dim"):
        flare_fused_fwd(q, k, v)
    q, k, v = _inputs((1, 2, 16, 33, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="several devices"):
        flare_encode(q.cpu(), k, v)
    with pytest.raises(ValueError, match="unit D stride"):
        flare_encode(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)


def _bwd_close(got, want, rel):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.double() - w).abs().max() <= rel * w.abs().max()


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 300, 70000, 8)])
def test_fused_bwd_matches_plain(cuda, shape, dtype):
    """The backward kernel against the plain backward in fp64 on the kernel's
    own residuals (the last shape takes the N-split and its sums)."""
    q, k, v = _inputs(shape, dtype, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    y, *res = flare_fused_fwd(q, k, v)
    before = launch_counts()["flare_fused_bwd"]
    got = flare_fused_bwd(q, k, v, *res, y, dy)
    torch.cuda.synchronize()
    assert launch_counts()["flare_fused_bwd"] == before + 1
    assert [g.dtype for g in got] == [dtype] * 3
    want = ref.flare_fused_bwd_ref(*(t.double() for t in (q, k, v, *res, y, dy)), chunk=8192)
    _bwd_close(got, want, 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("d", [1, 4, 8, 12, 16, 32, 64])
def test_fused_bwd_head_dims_match_plain(cuda, d, dtype):
    """Every head dim the backends promise runs at its MMA width (8, 16, 32,
    64), lanes beyond D zero: against the plain backward in fp64."""
    q, k, v = _inputs((2, 2, 40, 500, d), dtype, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    y, *res = flare_fused_fwd(q, k, v)
    got = flare_fused_bwd(q, k, v, *res, y, dy)
    want = ref.flare_fused_bwd_ref(*(t.double() for t in (q, k, v, *res, y, dy)))
    _bwd_close(got, want, 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("shape", [(2, 4, 16, 97, 8), (1, 2, 300, 70000, 8)])
def test_fused_bwd_gives_equal_bits_twice(cuda, shape):
    """Deterministic: fixed-order sums of fp32 partials, no float atomics
    (the second shape takes the token split and its sums)."""
    q, k, v = _inputs(shape, torch.float32, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    y, *res = flare_fused_fwd(q, k, v)
    first = flare_fused_bwd(q, k, v, *res, y, dy)
    second = flare_fused_bwd(q, k, v, *res, y, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_autograd_on_model_operands_near_fp64(cuda):
    """Block 0's q, k, v of the paper-scale surrogate on a pde_40k batch (two
    batch elements, two heads): gradients through FlareFused stay within
    1e-5 of max |grad| of the plain backward in fp64."""
    cfg = get_config("flare_pde")
    net = get_model(cfg, device=cuda).init(0)
    x = pointcloud_batch(0, 0, 2, grid=256, num_points=40000, device=cuda)["x"]
    with torch.no_grad():
        blk = net.blocks[0]
        hid = layernorm(blk.ln1, resmlp(net.in_proj, x))
        heads = lambda t: t.unflatten(2, (8, -1)).transpose(1, 2)[:, :2]
        q = blk.mixer.q_latent.detach()[:2].clone()
        k, v = heads(resmlp(blk.mixer.k_proj, hid)), heads(resmlp(blk.mixer.v_proj, hid))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    FlareFused.apply(q, k, v).backward(dy)
    with torch.no_grad():
        q64, k64, v64 = (t.detach().double() for t in (q, k, v))
        y64, *res64 = ref.flare_fused_fwd_ref(q64, k64, v64)
        want = ref.flare_fused_bwd_ref(q64, k64, v64, *res64, y64, dy.double(), chunk=8192)
    _bwd_close((q.grad, k.grad, v.grad), want, 1e-5)


def test_fused_bwd_raises_instead_of_falling_back(cuda):
    q, k, v = _inputs((1, 2, 16, 33, 8), torch.float32, cuda)
    y, z, mx, den, lse = flare_fused_fwd(q, k, v)
    with pytest.raises(ValueError, match="residuals"):
        flare_fused_bwd(q, k, v, z.double(), mx, den, lse, y, y)
    with pytest.raises(ValueError, match="several devices"):
        flare_fused_bwd(q, k, v, z.cpu(), mx, den, lse, y, y)


# ragged shapes where the autotuner proposes 1 or 2 token splits: D 8 (three
# row tiles), 12 (at the width 16: two) and 40 (at 64: one)
TUNE_SHAPES = [(2, 3, 70, 2500, 8), (1, 2, 40, 2100, 12), (1, 2, 33, 2200, 40)]


@pytest.mark.parametrize("shape", TUNE_SHAPES)
def test_every_autotune_candidate_matches_plain(cuda, shape):
    """Every candidate of both kinds (``backends/autotune.py``), fp32,
    against the plain version in fp64 at 1e-5 of max |out|: the encode and
    the decode ("tiles"), the fused forward and the backward with the
    candidate's split on the default forward's residuals ("packed")."""
    from repro_torch.backends import autotune
    from repro_torch.core.dispatch import MixerShape

    q, k, v = _inputs(shape, torch.float32, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    wide = [t.double() for t in (q, k, v)]
    at = MixerShape.from_qkv(q, k)
    z64 = ref.flare_encode_ref(*wide)
    tiles = autotune.tile_candidates(at)
    assert len(tiles) == 2 * len({c["block_m"] for c in tiles})
    for c in tiles:
        z = flare_encode(q, k, v, **c)
        assert _max_rel(z, z64) <= 1e-5, c
        y64 = ref.flare_decode_ref(wide[0], wide[1], z.double())
        assert _max_rel(flare_decode(q, k, z, block_m=c["block_m"]), y64) <= 1e-5, c
    y0, *res0 = flare_fused_fwd(q, k, v)
    fwd64 = ref.flare_fused_fwd_ref(*wide)
    bwd64 = ref.flare_fused_bwd_ref(*(t.double() for t in (q, k, v, *res0, y0, dy)))
    for c in autotune.packed_candidates(at):
        for got, want in zip(flare_fused_fwd(q, k, v, **c), fwd64):
            assert _max_rel(got, want) <= 1e-5, c
        _bwd_close(flare_fused_bwd(q, k, v, *res0, y0, dy, block_n=c["block_n"]), bwd64, 1e-5)


def test_refused_launch_parameters_leave_the_card_usable(cuda):
    """A row tile the library lacks is refused by the wrapper, and by the C
    entry point before any launch (an error code, never a sticky fault)."""
    from repro_torch.kernels.flare import decode_into, encode_into

    q, k, v = _inputs((2, 3, 70, 2500, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="block_m=96"):
        flare_encode(q, k, v, block_m=96)
    with pytest.raises(ValueError, match="block_n"):
        flare_fused_fwd(q, k, v, block_n=0)
    z = torch.empty(2, 3, 70, 8, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        encode_into(q, k, v, z, block_m=96)
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_into(q, k, z, torch.empty_like(k), block_m=128 + 64)
    torch.cuda.synchronize()
    torch.testing.assert_close(flare_encode(q, k, v), ref.flare_encode_ref(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_default_split_rule_matches_the_kernel_library(cuda):
    """``kernels/flare.py::default_splits`` (the rule the wrappers and the
    autotuner's defaults use) against ``flare_encode_splits`` in the built
    library, over a sweep holding pde_40k (B*H 64, M 2,048, N 40,000) and
    pde_1m (B*H 8, N 2^20); and the plans' defaults on this card."""
    from repro_torch.backends import autotune
    from repro_torch.core.dispatch import MixerShape, resolve
    from repro_torch.kernels import _build
    from repro_torch.kernels.flare import card_sms, default_splits

    lib = _build.lib()
    for sms in (132, 114, 78, card_sms(cuda)):
        for groups in (1, 2, 8, 24, 64, 512):
            for m in (16, 300, 2048, 4096):
                for n in (97, 1024, 5000, 40000, 300000, 1048576):
                    assert default_splits(groups, m, n, sms) == \
                        lib.flare_encode_splits(groups, m, n, sms), (groups, m, n, sms)
    for shape in (MixerShape(8, 8, 40000, 2048, 8), MixerShape(1, 8, 1048576, 2048, 8)):
        plan = resolve("packed", shape=shape, dtype=torch.float32, device="cuda")[1]
        splits = lib.flare_encode_splits(8 * shape.batch, 2048, shape.tokens, card_sms(cuda))
        if not autotune._load(autotune.cache_path()):   # an empty cache: the defaults
            assert -(-shape.tokens // plan.params["block_n"]) == splits
            assert plan.params["block_m"] == 256


# D 24 and 96 run at the padded widths 32 and 128
CAUSAL_SHAPES = [(2, 4, 16, 97, 8), (1, 3, 24, 300, 16), (2, 2, 70, 130, 32),
                 (1, 2, 64, 64, 64), (1, 2, 512, 1000, 128), (1, 1, 100, 4099, 128),
                 (1, 2, 40, 300, 24), (1, 2, 64, 500, 96)]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", CAUSAL_SHAPES)
def test_causal_kernel_matches_plain(cuda, shape, dtype):
    """Ragged T and ragged latent slices (M not a multiple of 64) included."""
    q, k, v = _inputs(shape, dtype, cuda)
    before = launch_counts()["flare_causal_chunk"]
    y = flare_causal_chunk(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts()["flare_causal_chunk"] == before + 1
    assert y.dtype == dtype and y.shape == k.shape
    if dtype == torch.float32:
        want = ref.flare_causal_chunk_ref(q.double(), k.double(), v.double(), tile=256)
        assert (y.double() - want).abs().max() <= 1e-5 * want.abs().max()
    else:
        torch.testing.assert_close(y, ref.flare_causal_chunk_ref(q, k, v), atol=2e-2, rtol=2e-2)


def _beyond_rounding(got, want) -> float:
    """max(|got - want| - 2^-8 |want|) / max |want|: the error of a bf16
    output beyond its own rounding."""
    return (((got.double() - want).abs() - 2.0 ** -8 * want.abs()).max()
            / want.abs().max()).item()


# the tensor-core route at D 8 (width 32), 64, 96 (width 128) and 128; ragged
# T and ragged latent slices
CAUSAL_TC_SHAPES = [(2, 2, 70, 300, 8), (1, 3, 100, 1000, 64), (1, 2, 64, 777, 96),
                    (1, 2, 512, 2050, 128), (2, 1, 130, 4099, 128)]


@pytest.mark.parametrize("shape", CAUSAL_TC_SHAPES)
def test_causal_tensor_cores_beyond_bf16_rounding(cuda, shape):
    """bf16 through the tensor-core kernel against the plain version in fp64
    on the same bf16 values: within 1e-5 of max |y| beyond the output's
    rounding, a limit that rejects the fp64 plain version with the 64-token
    tile at T/2 left out of the carried state (rounded to bf16); two calls
    give equal bits."""
    q, k, v = _inputs(shape, torch.bfloat16, cuda)
    wide = [t.double() for t in (q, k, v)]
    want = ref.flare_causal_chunk_ref(*wide, tile=256)
    y = flare_causal_chunk(q, k, v)
    assert y.dtype == torch.bfloat16 and _beyond_rounding(y, want) <= 1e-5
    assert torch.equal(y, flare_causal_chunk(q, k, v))
    t0 = shape[3] // 2 // 64 * 64
    kept = [torch.cat([t[:, :, :t0], t[:, :, t0 + 64:]], 2) for t in wide[1:]]
    rest = ref.flare_causal_chunk_ref(wide[0], *kept, tile=256)
    lost = want.clone()
    lost[:, :, t0 + 64:] = rest[:, :, t0:]
    assert _beyond_rounding(lost.bfloat16(), want) > 1e-5


def test_causal_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _inputs((1, 2, 16, 33, 130), torch.float32, cuda)    # D above 128
    with pytest.raises(ValueError, match="head dim"):
        flare_causal_chunk(q, k, v)
    q, k, v = _inputs((1, 2, 16, 33, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="several devices"):
        flare_causal_chunk(q.cpu(), k, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        flare_causal_chunk(q.requires_grad_(True), k, v)


def test_flare_lm_kernel_path_matches_plain_path(cuda):
    """The smoke LM's forward under causal_pallas (the kernel) against
    causal_stream (plain) on the same weights, fp32 compute: 1e-4 of max
    |logit|, 2 launches (one a layer)."""
    cfg = replace(get_smoke_config("flare_lm"), compute_dtype="float32")
    kern = get_model(cfg, device=cuda)
    assert kern.plans["infer"].backend == "causal_pallas"
    plain = get_model(cfg, device=cuda, policy=MixerPolicy(backends=("causal_stream",)))
    net = kern.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 300), generator=torch.Generator().manual_seed(0))
    before = launch_counts()["flare_causal_chunk"]
    got, _ = kern.forward(net, {"tokens": toks.to(cuda)})
    assert launch_counts()["flare_causal_chunk"] == before + cfg.num_layers
    want, _ = plain.forward(net, {"tokens": toks.to(cuda)})
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# G: a decode read of 1, 2, 6 (qwen2), 8 and 16 query rows a KV head (the
# decode instance, tiled above 8), 64 and 2048 latents (the encode instance
# at D <= 32, the decode instance's row tiles above)
PAGED_CASES = [(g, d, dt, q2) for g in (1, 2, 6, 8, 16, 64, 2048) for d in (8, 24, 96, 128)
               for dt in ("float32", "bfloat16", "int8", "fp8") for q2 in (False, True)]


def _paged_case(g, d, page_dtype, q2, device, *, b=4, h=2, block=16, pages=24, qdt=torch.float32):
    """Random operands: a shuffled page table whose unmapped entries point at
    a trash row of NaN, lengths 0, 1, a partial page and a full table."""
    from repro_torch.serve.pool.quant import get_quant, quantize

    gen = torch.Generator().manual_seed(g * 1000 + d)
    nb = b * pages + 1
    q = torch.randn(b, h, g, d, generator=gen) * d ** -0.5
    k = torch.randn(nb, block, h, d, generator=gen)
    v = torch.randn(nb, block, h, d, generator=gen)
    lengths = torch.tensor([0, 1, block * (pages // 2) + block // 2, block * pages],
                           dtype=torch.int32)[:b]
    pt = torch.randperm(nb - 1, generator=gen)[: b * pages].reshape(b, pages).int()
    for i in range(b):
        pt[i, -(-int(lengths[i]) // block):] = nb - 1
    k[nb - 1], v[nb - 1] = float("nan"), float("nan")
    kw = {}
    if page_dtype in ("int8", "fp8"):
        spec = get_quant(page_dtype)
        (k, ks), (v, vs) = quantize(spec, torch.nan_to_num(k)), quantize(spec, torch.nan_to_num(v))
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(getattr(torch, page_dtype)), v.to(getattr(torch, page_dtype))
    if q2:
        kw["q2"] = (torch.randn(b, h, g, 16, generator=gen) * 0.25).to(qdt)
        if k.dtype == torch.int8:
            kw["k2_pages"] = torch.randint(-100, 100, (nb, block, h, 16), generator=gen,
                                           dtype=torch.int8)
            kw["k2_scale"] = torch.full((nb, block, h), 0.01)
        else:
            kw["k2_pages"] = torch.randn(nb, block, h, 16, generator=gen).to(k.dtype)
    ops = (q.to(qdt), k, v, pt, lengths)
    return (tuple(t.to(device) for t in ops),
            {key: t.to(device) for key, t in kw.items()})


@pytest.mark.parametrize("g,d,page_dtype,q2", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, g, d, page_dtype, q2):
    from repro_torch.kernels.paged_attention import paged_attention

    ops, kw = _paged_case(g, d, page_dtype, q2, cuda)
    before = launch_counts()["paged_attention"]
    got = paged_attention(*ops, scale=0.7, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 1
    wide = {key: t.double() if key == "q2" else t for key, t in kw.items()}
    want = ref.paged_attention_ref(ops[0].double(), *ops[1:], scale=0.7,
                                   out_dtype=torch.float64, **wide)
    assert not got[0].any() and torch.isfinite(got).all()
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("g,d", [(6, 128), (2048, 8)])
def test_paged_kernel_bf16_plain_path(cuda, g, d):
    """bf16 queries over bf16 pages (the plain path: weights rounded to bf16
    before the value product) with a bf16 output."""
    from repro_torch.kernels.paged_attention import paged_attention

    ops, _ = _paged_case(g, d, "bfloat16", False, cuda, qdt=torch.bfloat16)
    got = paged_attention(*ops, scale=0.7)
    assert got.dtype == torch.bfloat16
    want = ref.paged_attention_ref(ops[0].double(), *ops[1:], scale=0.7, out_dtype=torch.float64)
    assert (got.double() - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("g,d,page_dtype", [(6, 128, "bfloat16"), (1, 96, "float32"),
                                             (2048, 8, "float32"), (64, 24, "int8")])
def test_paged_kernel_gives_equal_bits_twice(cuda, g, d, page_dtype):
    """Deterministic: the page slices merge in a fixed order, no atomics."""
    from repro_torch.kernels.paged_attention import paged_attention

    ops, kw = _paged_case(g, d, page_dtype, True, cuda)
    first = paged_attention(*ops, scale=0.7, out_dtype=torch.float32, **kw)
    second = paged_attention(*ops, scale=0.7, out_dtype=torch.float32, **kw)
    assert torch.equal(first, second)


def test_paged_kernel_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.paged_attention import paged_attention

    ops, _ = _paged_case(6, 128, "bfloat16", False, cuda)
    q, k, v, pt, lengths = ops
    wide = [torch.cat([t] * 4 + [t[..., :8]], -1) for t in (q, k, v)]   # D = 520, above 512
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(*wide, pt, lengths)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, k, v, pt.long(), lengths)
    with pytest.raises(ValueError, match="several devices"):
        paged_attention(q, k, v, pt.cpu(), lengths)


# MLA's absorbed decode read (the MLA instance, D > 128): DeepSeek-V2-Lite's
# G = 16, D = 512, D2 = 64 and MiniCPM3's G = 40, D = 256, D2 = 32, one page
# head, the latents both K and V; a tile of query rows (G = 70) and a D that
# is no power of two (200, D2 16)
MLA_CASES = [(g, d, d2, dt) for g, d, d2 in ((16, 512, 64), (40, 256, 32), (70, 200, 16))
             for dt in ("float32", "bfloat16", "int8", "fp8")]


def _mla_case(g, d, d2, page_dtype, device, *, block=16, pages=24):
    """One page head of latents (the same tensor as K and V) and rotary keys
    over a shuffled page table whose unmapped entries point at a trash row of
    NaN, lanes of 0, 1, 200 and 337 tokens (each ending inside a 32-token
    tile of the kernel and inside a page) and a full table."""
    gen = torch.Generator().manual_seed(g * 1000 + d)
    lengths = torch.tensor([0, 1, 200, 337, block * pages], dtype=torch.int32)
    b = len(lengths)
    nb = b * pages + 1
    pt = torch.randperm(nb - 1, generator=gen)[: b * pages].reshape(b, pages).int()
    for i in range(b):
        pt[i, -(-int(lengths[i]) // block):] = nb - 1
    q = torch.randn(b, 1, g, d, generator=gen) * d ** -0.5
    kw = {"q2": torch.randn(b, 1, g, d2, generator=gen) * d2 ** -0.5}
    c = torch.randn(nb, block, 1, d, generator=gen)
    kr = torch.randn(nb, block, 1, d2, generator=gen)
    if page_dtype in ("int8", "fp8"):
        from repro_torch.serve.pool.quant import get_quant, quantize

        spec = get_quant(page_dtype)
        (c, cs), (kr, krs) = quantize(spec, c), quantize(spec, kr)
        kw.update(k_scale=cs, v_scale=cs, k2_scale=krs)
    else:
        c, kr = c.to(getattr(torch, page_dtype)), kr.to(getattr(torch, page_dtype))
    if c.is_floating_point():
        c[nb - 1] = float("nan")
    kw["k2_pages"] = kr
    c = c.to(device)
    return (q.to(device), c, c, pt.to(device), lengths.to(device)), {
        key: t.to(device) for key, t in kw.items()}


@pytest.mark.parametrize("g,d,d2,page_dtype", MLA_CASES)
def test_paged_mla_read_matches_plain(cuda, g, d, d2, page_dtype):
    """The bf16 tensor-core instance for bf16, int8 and fp8 pages, the TF32
    one for fp32 pages (the route's launch count), against fp64; a lane of
    length 0 exact zeros; the same call twice gives equal bits."""
    from repro_torch.kernels.paged_attention import paged_attention

    ops, kw = _mla_case(g, d, d2, page_dtype, cuda)
    before = launch_counts()["paged_attention"]
    routes = dict(paged_attention.launches_by_route)
    got = paged_attention(*ops, scale=0.1, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 1
    route = "mla_tf32" if page_dtype == "float32" else "mla_tc"
    assert {r: n - routes[r] for r, n in paged_attention.launches_by_route.items()} == {
        r: int(r == route) for r in routes}
    wide = {key: t.double() if key == "q2" else t for key, t in kw.items()}
    want = ref.paged_attention_ref(ops[0].double(), *ops[1:], scale=0.1,
                                   out_dtype=torch.float64, **wide)
    assert not got[0].any() and torch.isfinite(got).all()
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(paged_attention(*ops, scale=0.1, out_dtype=torch.float32, **kw), got)


def test_paged_mla_read_separate_v_and_equal_bits(cuda):
    """The MLA instance with V its own pages (D = 256), against fp64; and
    the same call twice gives equal bits."""
    from repro_torch.kernels.paged_attention import paged_attention

    ops, kw = _mla_case(16, 256, 32, "bfloat16", cuda)
    q, c, _, pt, lengths = ops
    v = torch.randn(c.shape, device=cuda).to(c.dtype)
    got = paged_attention(q, c, v, pt, lengths, scale=0.1, out_dtype=torch.float32, **kw)
    wide = {key: t.double() if key == "q2" else t for key, t in kw.items()}
    want = ref.paged_attention_ref(q.double(), c, v, pt, lengths, scale=0.1,
                                   out_dtype=torch.float64, **wide)
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    again = paged_attention(q, c, v, pt, lengths, scale=0.1, out_dtype=torch.float32, **kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("d,d2", [(256, 32), (512, 64)])
def test_paged_mla_read_fp32_separate_v(cuda, d, d2):
    """The TF32 instance with V its own fp32 pages (at D 512 one stage of
    the ring: K and V rows do not fit twice), against fp64; a lane of
    length 0 exact zeros; the same call twice gives equal bits."""
    from repro_torch.kernels.paged_attention import paged_attention

    ops, kw = _mla_case(16, d, d2, "float32", cuda)
    q, c, _, pt, lengths = ops
    v = torch.randn(c.shape, device=cuda)
    v[-1] = float("nan")
    routes = dict(paged_attention.launches_by_route)
    got = paged_attention(q, c, v, pt, lengths, scale=0.1, out_dtype=torch.float32, **kw)
    assert paged_attention.launches_by_route["mla_tf32"] == routes["mla_tf32"] + 1
    wide = {key: t.double() if key == "q2" else t for key, t in kw.items()}
    want = ref.paged_attention_ref(q.double(), c, v, pt, lengths, scale=0.1,
                                   out_dtype=torch.float64, **wide)
    assert not got[0].any() and torch.isfinite(got).all()
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    again = paged_attention(q, c, v, pt, lengths, scale=0.1, out_dtype=torch.float32, **kw)
    assert torch.equal(got, again)


def test_qwen2_engine_kernel_route_matches_gather(cuda):
    """The smoke qwen2 on the card: the engine's kernel route (one launch a
    layer a decode step) gives the gather route's greedy tokens, fp32 compute."""
    import numpy as np

    from repro_torch.serve.engine import ServeEngine

    cfg = replace(get_smoke_config("qwen2_1_5b"), compute_dtype="float32")
    model = get_model(cfg, device=cuda)
    net = model.init(0)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, int(n)), int(m))
            for n, m in zip(rng.integers(3, 14, 5), rng.integers(3, 11, 5))]
    outs = {}
    for route in ("gather", "paged"):
        eng = ServeEngine(model, net, capacity=32, slots=2, pool_tokens=96, block_size=8,
                          decode_backend=route)
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new_tokens=max_new)
        before = launch_counts()["paged_attention"]
        outs[route] = [o.tolist() for o in eng.run_all()]
        launched = launch_counts()["paged_attention"] - before
        assert launched == (cfg.num_layers * eng.stats["decode_steps"] if route == "paged" else 0)
        eng.check_invariants()
    assert outs["paged"] == outs["gather"]


def test_zamba_engine_kernel_route_matches_gather(cuda):
    """The smoke Zamba2 on the card: the kernel route (one paged launch a
    shared invocation a decode step, "auto" picking it) gives the gather
    route's and the dense pool's greedy tokens, fp32 compute."""
    from repro_torch.serve.engine import ServeEngine

    cfg, model, net, reqs = _smoke_serving("zamba2_7b", cuda)
    outs = {}
    for route, kw in (("dense", {}), ("gather", dict(decode_backend="gather")),
                      ("paged", {})):
        paged = dict(pool_tokens=96, block_size=8) if route != "dense" else {}
        eng = ServeEngine(model, net, capacity=32, slots=2, **paged, **kw)
        before = launch_counts()["paged_attention"]
        outs[route] = _served(eng, reqs)
        launched = launch_counts()["paged_attention"] - before
        assert launched == (_paged_reads(cfg) * eng.stats["decode_steps"] if route == "paged"
                            else 0)
        if route != "dense":
            eng.check_invariants()
    assert outs["paged"] == outs["gather"] == outs["dense"]


# the serving engine's decode step captured as one CUDA graph: (arch, engine kw)
GRAPH_ROUTES = {"gqa-dense": ("qwen2_1_5b", {}),
                "gqa-gather": ("qwen2_1_5b", dict(pool_tokens=96, block_size=8,
                                                  decode_backend="gather")),
                "gqa-kernel": ("qwen2_1_5b", dict(pool_tokens=96, block_size=8,
                                                  decode_backend="paged")),
                "flare_lm": ("flare_lm", {}),
                "deepseek-kernel": ("deepseek_v2_lite_16b", dict(pool_tokens=96, block_size=8,
                                                                 decode_backend="paged")),
                "rwkv-dense": ("rwkv6_3b", {}),
                "zamba-dense": ("zamba2_7b", {}),
                "zamba-kernel": ("zamba2_7b", dict(pool_tokens=96, block_size=8,
                                                   decode_backend="paged"))}


def _paged_reads(cfg) -> int:
    """Paged-kernel reads a decode step on the kernel route: one a layer,
    one a shared-attention invocation for the hybrid."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def _smoke_serving(arch, device, n=5, seed=0):
    """(cfg, model, net, requests): a smoke LM in fp32 compute on the card."""
    import numpy as np

    cfg = replace(get_smoke_config(arch), compute_dtype="float32")
    model = get_model(cfg, device=device)
    net = model.init(0)
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, cfg.vocab, int(k)), int(m))
            for k, m in zip(rng.integers(3, 14, n), rng.integers(3, 11, n))]
    return cfg, model, net, reqs


def _served(engine, reqs):
    for prompt, max_new in reqs:
        engine.submit(prompt, max_new_tokens=max_new)
    return [o.tolist() for o in engine.run_all()]


@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_engine_graph_replay_matches_eager(cuda, route):
    """Warmup captures the decode step; every serving step replays it: the
    greedy tokens equal the eager step's (fp32 compute), the step is built
    once, and the paged launches counted are layers x steps on the kernel
    routes (a replay adds the launches its capture recorded), none
    elsewhere."""
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.serve.engine import ServeEngine

    arch, kw = GRAPH_ROUTES[route]
    cfg, model, net, reqs = _smoke_serving(arch, cuda)
    graph = ServeEngine(model, net, capacity=32, slots=2, **kw)
    graph.warmup(max_prompt_len=16)
    assert graph._graph is not None and graph.stats["decode_compiles"] == 1
    reset_launch_counts()
    got = _served(graph, reqs)
    counts = launch_counts()
    assert graph.stats["decode_compiles"] == 1
    per_step = _paged_reads(cfg) if kw.get("decode_backend") == "paged" else 0
    assert counts["paged_attention"] == per_step * graph.stats["decode_steps"]
    eager = ServeEngine(model, net, capacity=32, slots=2, cuda_graph=False, **kw)
    assert got == _served(eager, reqs)
    assert eager._graph is None and eager.stats["decode_compiles"] == 0


def test_engine_graph_replays_draw_fresh_noise(cuda):
    """Temperature sampling through the replayed step: near-uniform draws
    (temperature 1e4) differ from step to step within each request, so
    each replay draws fresh noise; the same seed repeats every token and
    another seed draws others."""
    from repro_torch.serve.engine import ServeEngine

    _, model, net, reqs = _smoke_serving("qwen2_1_5b", cuda, n=3)
    reqs = [(prompt, 12) for prompt, _ in reqs]

    def run(seed):
        eng = ServeEngine(model, net, capacity=32, slots=4, pool_tokens=128, block_size=8,
                          temperature=1e4, seed=seed)
        eng.warmup(max_prompt_len=16)
        out = _served(eng, reqs)
        assert eng._graph is not None and eng.stats["decode_compiles"] == 1
        return out

    first = run(7)
    assert all(len(set(toks[1:])) > 1 for toks in first)   # toks[0]: the prefill's draw
    assert run(7) == first
    assert run(8) != first


def test_launch_counts_after_replays(cuda):
    """N replayed steps of the kernel route: launch_counts() and the per-route
    counts show N x layers paged launches, and the capture itself none."""
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serve.engine import ServeEngine

    cfg, model, net, reqs = _smoke_serving("qwen2_1_5b", cuda, n=2)
    eng = ServeEngine(model, net, capacity=32, slots=2, pool_tokens=96, block_size=8,
                      decode_backend="paged")
    reset_launch_counts()
    eng.warmup(max_prompt_len=16)
    assert launch_counts()["paged_attention"] == cfg.num_layers   # the eager run alone
    reset_launch_counts()
    for prompt, _ in reqs:
        eng.submit(prompt, max_new_tokens=30)
    steps = 6
    for _ in range(steps):
        eng.step()
    assert eng.stats["decode_steps"] == steps
    assert launch_counts()["paged_attention"] == cfg.num_layers * steps
    assert paged_attention.launches_by_route["decode"] == cfg.num_layers * steps


CAPTURE_FAILS = r"""
import dataclasses, sys
import numpy as np
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.models.api import get_model
from repro_torch.serve.engine import ServeEngine

model = get_model(replace(get_smoke_config("qwen2_1_5b"), compute_dtype="float32"),
                  device="cuda")
step = model.decode_step


def syncing(net, token, caches):
    logits, caches = step(net, token, caches)
    logits.sum().item()   # a host sync: legal eagerly, refused under capture
    return logits, caches


eng = ServeEngine(dataclasses.replace(model, decode_step=syncing), model.init(0), capacity=32,
                  slots=2)
eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
try:
    eng.step()
except RuntimeError:
    print("raised", eng._graph is None, eng.stats["decode_steps"])
    sys.exit(3)
print("served")
"""


def test_engine_capture_failure_raises(cuda):
    """A decode step that cannot be captured (a host sync inside it) raises
    at the capture, which follows the first eager run: the engine never
    falls back to the eager step. In a process of its own, since a failed
    capture leaves the process on the capture's stream."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 3, out.stdout + out.stderr
    assert "raised True 0" in out.stdout


# (B, H, Hkv, Sq, Skv, D): GQA (Hkv < H) included; D 16 / 32 / 64 / 96 / 128
# and 24 at padded widths, and 5 (two-byte loads, the bf16_mma route in bf16)
FLASH_SHAPES = [(2, 3, 3, 97, 97, 24), (1, 2, 2, 300, 300, 96), (1, 2, 2, 128, 64, 128),
                (2, 2, 2, 64, 200, 96), (1, 4, 4, 1030, 1030, 128), (1, 1, 1, 70, 70, 5),
                (1, 6, 2, 300, 300, 16), (2, 6, 1, 200, 200, 32), (1, 6, 3, 257, 257, 64),
                (1, 12, 2, 1030, 1030, 128)]
FLASH_MASKS = [(True, None), (False, None), (True, 24)]
BF16_U = 2.0 ** -8   # bf16's unit roundoff: rounding moves x by at most 2**-8 |x|


def _flash_inputs(shape, dtype, device, seed=0):
    """q, k, v as the model gives them: [B, H, S, D] views of [B, S, H, D],
    k and v of Hkv heads."""
    b, h, hkv, sq, skv, d = shape
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, n, heads, d, generator=gen).to(device, dtype).transpose(1, 2)
                 for n, heads in ((sq, h), (skv, hkv), (skv, hkv)))


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, causal, window, dtype):
    """GQA, D 5 to 128, ragged Sq and Skv (ending inside the kernels' key
    tiles), Sq > Skv with fully masked rows, Skv > Sq; every bf16 call on
    both bf16 routes, and each call's route asserted (flash_route: the
    tensor cores for bf16 at D % 8 == 0, the TF32 kernel for fp32) by the
    launch counts; two calls give equal bits."""
    from repro_torch.kernels.attention import flash_attention, flash_route

    q, k, v = _flash_inputs(shape, dtype, cuda)
    kw = dict(scale=shape[-1] ** -0.5, causal=causal, window=window)
    want64 = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    routes = {torch.float32: ["fp32"],
              torch.bfloat16: ["tensor_core", "bf16_mma"] if shape[-1] % 8 == 0
              else ["bf16_mma"]}[dtype]
    assert flash_route(q, k, v) == routes[0]
    for route in routes:
        before = dict(flash_attention.launches_by_route)
        call = lambda: flash_attention(q, k, v, **kw, route=None if route == routes[0] else route)
        o = call()
        torch.cuda.synchronize()
        assert {r: n - before[r] for r, n in flash_attention.launches_by_route.items()} == {
            r: int(r == route) for r in before}
        assert torch.equal(call(), o)
        assert o.dtype == dtype and o.shape == q.shape and bool(torch.isfinite(o).all())
        if dtype == torch.float32:
            assert (o.double() - want64).abs().max() <= 1e-5 * want64.abs().max()
            continue
        want = ref.flash_attention_ref(q, k, v, **kw)
        assert (o.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
        excess = ((o.double() - want64).abs() - BF16_U * want64.abs()).max()
        assert excess <= 1e-5 * want64.abs().max(), (route, excess.item())


@pytest.mark.parametrize("case", ["D=100", "base off by 8 bytes"])
def test_flash_off_tma_calls_take_the_bf16_mma_route(cuda, case):
    """bf16 calls flash_route itself sends off TMA (D=100: 200-byte rows; a
    D=128 view whose base is 8 bytes off), GQA, causal with a window:
    launched on the bf16_mma route (by count), against the plain version and
    beyond bf16's output rounding against fp64; two calls give equal bits."""
    from repro_torch.kernels.attention import flash_attention, flash_route

    if case == "D=100":
        q, k, v = _flash_inputs((1, 6, 2, 300, 300, 100), torch.bfloat16, cuda)
    else:
        q, k, v = _flash_inputs((1, 6, 2, 300, 300, 128), torch.bfloat16, cuda)
        q, k, v = (torch.cat([torch.zeros(4, dtype=t.dtype, device=cuda), t.flatten()])[4:]
                   .view(t.shape) for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    assert flash_route(q, k, v) == "bf16_mma"
    kw = dict(scale=q.shape[-1] ** -0.5, causal=True, window=100)
    before = dict(flash_attention.launches_by_route)
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in flash_attention.launches_by_route.items()} == {
        r: int(r == "bf16_mma") for r in before}
    assert torch.equal(flash_attention(q, k, v, **kw), o)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (o.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    want64 = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    excess = ((o.double() - want64).abs() - BF16_U * want64.abs()).max()
    assert excess <= 1e-5 * want64.abs().max(), excess.item()


def test_flash_bf16_mma_takes_more_than_65535_groups(cuda):
    """B*H rides on gridDim.x: 65,540 query heads over 16,385 KV heads at a
    tiny Sq (3) and D=5 run on the bf16_mma route, against the plain version."""
    from repro_torch.kernels.attention import flash_attention

    q, k, v = _flash_inputs((1, 65540, 16385, 3, 3, 5), torch.bfloat16, cuda)
    kw = dict(scale=5 ** -0.5, causal=True)
    before = flash_attention.launches_by_route["bf16_mma"]
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["bf16_mma"] == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (o.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


def test_flash_kernel_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.attention import flash_attention

    q, k, v = _flash_inputs((1, 2, 2, 33, 33, 136), torch.float32, cuda)     # D above 128
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v, scale=1.0)
    q, k, v = _flash_inputs((1, 2, 2, 33, 33, 5), torch.bfloat16, cuda)   # D=5: no TMA
    with pytest.raises(ValueError, match="route 'tensor_core'"):
        flash_attention(q, k, v, scale=1.0, route="tensor_core")
    q, k, v = _flash_inputs((1, 2, 2, 33, 33, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="route 'tensor_core'"):
        flash_attention(q, k, v, scale=1.0, route="tensor_core")
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(q.cpu(), k, v, scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.double(), k.double(), v.double(), scale=1.0)
    with pytest.raises(ValueError, match="unit D stride"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, scale=1.0)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(True), k, v, scale=1.0)


def test_qwen2_prefill_pallas_matches_chunked(cuda):
    """The smoke qwen2's prefill with right-padded lengths through the flash
    kernel (one launch a layer) against the chunked route, fp32 compute."""
    from repro_torch.models import transformer

    cfg = replace(get_smoke_config("qwen2_1_5b"), compute_dtype="float32")
    net = get_model(cfg, device=cuda).init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 300), generator=gen).to(cuda),
             "lengths": torch.tensor([300, 217], device=cuda)}
    with torch.no_grad():
        before = launch_counts()["flash_attention"]
        got, caches = transformer.lm_prefill(net, batch, cfg, 320, impl="pallas")
        assert launch_counts()["flash_attention"] == before + cfg.num_layers
        want, want_caches = transformer.lm_prefill(net, batch, cfg, 320, impl="chunked")
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for a, b in zip(caches.layers, want_caches.layers):
        torch.testing.assert_close(a.k, b.k, atol=2e-2, rtol=2e-2)


# the sharded mixer's four entry points (kernels/flare_packed_shard.py):
# ragged N, the N-split at 70,000 tokens, a widened D
SHARD_SHAPES = [(2, 4, 16, 97, 8), (1, 2, 300, 70000, 8), (2, 3, 24, 301, 12)]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_shard_entry_points_on_one_rank_equal_the_fused_kernels(cuda, shape, dtype):
    """On a group of one the merge scales by exp(0) and forms Z as num * (1/den),
    as the encode does: the pipeline is the fused kernels' own arithmetic
    (held at 1e-6 of max |.|; expected bit-identical)."""
    q, k, v = _inputs(shape, dtype, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    y, z, mx, den, lse = flare_fused_fwd(q, k, v)
    before = launch_counts()
    zs, gmx, gden = combine_stats(*flare_enc_stats(q, k, v), None)
    ys, lses = flare_shard_decode(q, k, zs)
    dz = flare_shard_dz(q, k, lses, dy)
    got = flare_shard_grads(q, k, v, zs, gmx, gden, lses, ys, dy, dz)
    after = launch_counts()
    assert all(after[n] == before[n] + 1 for n in ("flare_enc_stats", "flare_shard_decode",
                                                     "flare_shard_dz", "flare_shard_grads"))
    for g, w in zip((zs, gmx, gden, ys, lses), (z, mx, den, y, lse)):
        assert g.dtype == w.dtype and _max_rel(g, w) <= 1e-6
    for g, w in zip(got, flare_fused_bwd(q, k, v, z, mx, den, lse, y, dy)):
        assert g.dtype == w.dtype and _max_rel(g, w) <= 1e-6


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_shard_entry_points_over_three_slices_match_plain(cuda, shape, dtype):
    """Three ranks emulated on one card, N cut raggedly: the slices'
    statistics merged by the plain merge, decoded per slice, dZ summed over
    the slices, the gradients per slice; against the plain forward and
    backward in fp64 (fp32 1e-5, bf16 2e-2 of max |.|)."""
    q, k, v = _inputs(shape, dtype, cuda)
    n = k.shape[2]
    cuts = [0, n // 3 + 1, 2 * n // 3 + 1, n]
    parts = [slice(a, b) for a, b in zip(cuts, cuts[1:])]
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    stats = [flare_enc_stats(q, k[:, :, s], v[:, :, s]) for s in parts]
    z, mx, den = ref.combine_stats_ref(*(torch.stack(t) for t in zip(*stats)))
    dec = [flare_shard_decode(q, k[:, :, s], z) for s in parts]
    dz = sum(flare_shard_dz(q, k[:, :, s], lse, dy[:, :, s]) for s, (_, lse) in zip(parts, dec))
    grads = [flare_shard_grads(q, k[:, :, s], v[:, :, s], z, mx, den, lse, y, dy[:, :, s], dz)
             for s, (y, lse) in zip(parts, dec)]
    y = torch.cat([y for y, _ in dec], dim=2)
    dq = sum(g[0].double() for g in grads)
    dk, dv = (torch.cat([g[i] for g in grads], dim=2) for i in (1, 2))
    wide = tuple(t.double() for t in (q, k, v))
    y64, *res64 = ref.flare_fused_fwd_ref(*wide)
    want = ref.flare_fused_bwd_ref(*wide, *res64, y64, dy.double(), chunk=8192)
    limit = 1e-5 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and _max_rel(y, y64) <= limit
    for g, w in zip((dq, dk, dv), want):
        assert _max_rel(g, w) <= limit
    # the merge must see every slice: one left out moves y past the limit
    lost = ref.combine_stats_ref(*(torch.stack([t[0], t[2]]) for t in zip(*stats)))[0]
    y_lost = torch.cat([flare_shard_decode(q, k[:, :, s], lost)[0] for s in parts], dim=2)
    assert _max_rel(y_lost, y64) > limit


@pytest.mark.parametrize("mixer", ["attn", "flare"])
def test_seamless_prefill_kernel_route_matches_plain(cuda, mixer):
    """The smoke seamless-m4t on the card, fp32 compute: the prefill on the
    kernel route (``impl="pallas"``: the flash kernel for the encoder's
    non-causal self-attention, the decoder's causal one and the
    cross-attention; the FLARE encoder under the model's plan, the fused
    kernel) against the plain route (``chunked`` attention, the ``sdpa``
    policy): the memory and the last token's logits within 1e-4 of their
    max, the launches counted on the kernel route and none on the plain
    route or in a decode step."""
    from repro_torch.configs.seamless_m4t_large_v2 import smoke_config
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.ops import count_delta, count_snapshot
    from repro_torch.models import transformer

    cfg = replace(smoke_config(mixer), compute_dtype="float32")
    model = get_model(cfg, device=cuda)
    plain = get_model(cfg, device=cuda, policy=MixerPolicy(backends=("sdpa",)))
    net = model.init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {"embeds": torch.randn(2, 300, cfg.d_model, generator=gen).to(cuda),
             "tokens": torch.randint(0, cfg.vocab, (2, 37), generator=gen).to(cuda)}
    with torch.no_grad():
        before = count_snapshot()
        got, caches = transformer.encdec_prefill(net, batch, cfg, 48, impl="pallas",
                                                 plan=model.plans.get("infer"))
        kernel_route = count_delta(before, count_snapshot())
        before = count_snapshot()
        want, want_caches = transformer.encdec_prefill(net, batch, cfg, 48, impl="chunked",
                                                       plan=plain.plans.get("infer"))
        tok = want.argmax(-1)[:, None]
        model.decode_step(net, tok, want_caches)
        assert count_delta(before, count_snapshot()) == {}
    flash = 2 * cfg.num_layers + (cfg.num_encoder_layers if mixer == "attn" else 0)
    expected = {(flash_attention, None): flash, (flash_attention, "fp32"): flash}
    if mixer == "flare":
        assert model.plans["infer"].backend == "packed"
        expected[flare_fused_fwd, None] = cfg.num_encoder_layers
    assert kernel_route == expected
    assert (caches.memory - want_caches.memory).abs().max() <= 1e-4 * want_caches.memory.abs().max()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_fused_bwd_at_seamless_shape(cuda, dtype):
    """The backward kernel at one microbatch of seamless-m4t's FLARE encoder
    (B=1, H=16, M=256, N=4,096, D=64) against the plain backward in fp64:
    fp32 within 1e-5 of each gradient's max |g|; bf16 beyond its output
    rounding within 1e-5 (the kernel computes in fp32 and rounds only its
    outputs). The plain backward whose dZ lost one 64-token tile must fail
    the same limit."""
    q, k, v = _inputs((1, 16, 256, 4096, 64), dtype, cuda)
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    y, *res = flare_fused_fwd(q, k, v)
    got = flare_fused_bwd(q, k, v, *res, y, dy)
    wide = [t.double() for t in (q, k, v, *res, y, dy)]
    q64, k64, v64, z64, mx64, den64, lse64, y64, dy64 = wide
    want = ref.flare_fused_bwd_ref(*wide)
    dz = ref.flare_bwd_dz_ref(q64, k64[:, :, 64:], lse64[:, :, 64:], dy64[:, :, 64:])
    lost = ref.flare_bwd_grads_ref(*wide, dz)
    err = _beyond_rounding if dtype == torch.bfloat16 else _max_rel
    for g, w, x in zip(got, want, lost):
        assert g.dtype == dtype and err(g, w) <= 1e-5
        assert err(x.to(dtype), w) > 1e-5


def test_fused_layer_under_remat_launches_twice_forward(cuda):
    """One FLARE layer through ``FlareFused`` under ``_remat(.., "full")``
    (the encoder's checkpointing): a train step launches the fused forward
    twice (the forward and its recomputation) and the backward once, and
    gives the gradients of the same layer without checkpointing."""
    from repro_torch.core.flare import flare_layer, init_flare_layer
    from repro_torch.models.transformer import _remat

    layer = init_flare_layer(128, 2, 32, generator=torch.Generator().manual_seed(0),
                             device=cuda)
    x = torch.randn(2, 300, 128, generator=torch.Generator().manual_seed(1)).to(cuda)
    policy = MixerPolicy(backends=("packed",))
    grads = {}
    for mode in ("full", "none"):
        fn = _remat(lambda lyr, h: flare_layer(lyr, h, policy=policy), mode)
        before = launch_counts()
        fn(layer, x).square().sum().backward()
        after = launch_counts()
        grads[mode] = [p.grad.clone() for p in layer.parameters()]
        layer.zero_grad(set_to_none=True)
        moved = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        assert moved == {"flare_fused_fwd": 2 if mode == "full" else 1, "flare_fused_bwd": 1}
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_fused_bwd_on_encoder_layer_operands_near_fp64(cuda):
    """The fp32 backward kernel at D=64 on the operands of a FLARE encoder
    layer of seamless-m4t's width (d_model 1,024, 16 heads, 256 latents,
    ResMLP K/V projections; standard normal frames, B=2, N=4,096), whose
    sums over D cancel in dZ v^T - delta_e: dq, dk and dv within 1e-5 of
    each max |g| of the plain backward in fp64 (the sums over D chained in
    the tensor core left 1.0-1.06e-5 on the model's own layer 0)."""
    import torch.nn.functional as F

    from repro_torch.core.flare import _split_heads, init_flare_layer

    gen = torch.Generator(device=cuda).manual_seed(0)
    layer = init_flare_layer(1024, 16, 256, generator=gen, device=cuda)
    x = F.layer_norm(torch.randn(2, 4096, 1024, generator=gen, device=cuda), (1024,))
    with torch.no_grad():
        q = layer.q_latent.detach()
        k, v = (_split_heads(resmlp(proj, x), 16) for proj in (layer.k_proj, layer.v_proj))
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    y, *res = flare_fused_fwd(q, k, v)
    got = flare_fused_bwd(q, k, v, *res, y, dy)
    want = ref.flare_fused_bwd_ref(*(t.double() for t in (q, k, v, *res, y, dy)))
    errs = [_max_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= 1e-5, errs
