"""The numeric choices of the tensor-core kernels that split their operands,
on the CPU.

``kernels/ref.py::flash_attention_tf32_ref`` emulates the products of
``csrc/flash_attention.cu::flash_tf32_kernel`` (fp32 q, k, v and the weights
in two TF32 parts, three MMAs a product), ``ref.flash_attention_bf16_split_ref``
those of the bf16 routes (``flash_bf16_kernel`` off TMA's route and
``flash_tc_kernel``: bf16 q, k, v exact, the weights in two bf16 parts),
``ref.flare_causal_split_ref(split="tf32")`` those of
``csrc/flare_causal.cu::causal_tf32_kernel`` (fp32 q, k, v and every
intermediate in two TF32 parts) and ``ref.paged_mla_split_ref`` those of
``csrc/paged_attention.cu::paged_mla_tc_kernel`` (the pages widened to bf16,
fp32 q in three bf16 parts, the weights in two), ``ref.paged_mla_tf32_ref``
those of ``paged_mla_tf32_kernel`` (fp32 pages: q, the pages and the
weights in two TF32 parts, three MMAs a product). Each emulation is held
within 1e-5 of max |o| of the plain version in fp64 (chip_smoke.py's RTOL,
the kernels' limit on the card; a bf16 output beyond its own rounding, as
``Checks.hold_rounded`` holds it), and a control with each operand rounded
once must fail that limit; each is also held against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs. Widening int8 and
e4m3 pages to bf16 is exact, and three bf16 parts give an fp32 value back
exactly."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention_pallas
from repro.kernels.flare_causal import flare_causal_chunk_pallas
from repro.kernels.paged_attention import paged_attention as jpaged_attention
from repro_torch.kernels import ref

LIMIT = 1e-5
FLASH_MASKS = [(True, None), (False, None), (True, 24)]


def _rel(got, want) -> float:
    want = torch.as_tensor(np.array(want)).double()
    return ((torch.as_tensor(np.array(got)).double() - want).abs().max()
            / want.abs().max()).item()


def _flash_inputs(seed=0, b=1, h=4, hkv=2, s=256, d=64):
    """q, k, v as numpy fp32 [B, H, S, D] / [B, Hkv, S, D]; q scaled up so the
    scores reach ~10, as a trained model's do."""
    rng = np.random.default_rng(seed)
    q = (3 * rng.standard_normal((b, h, s, d)) / np.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_tf32_split_meets_the_fp32_limit_one_rounding_does_not(causal, window):
    """GQA (4 query heads over 2 KV heads), S=256, D=64: the three-way TF32
    products within 1e-5 of max |o| of fp64; hi alone (one TF32 rounding of
    each operand) beyond it."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs())
    kw = dict(scale=64 ** -0.5, causal=causal, window=window)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    errs = {parts: _rel(ref.flash_attention_tf32_ref(q, k, v, parts=parts, **kw), want)
            for parts in (2, 1)}
    assert errs[2] <= LIMIT, errs
    assert errs[1] > LIMIT, errs


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_tf32_emulation_matches_jax_pallas(causal, window):
    """The emulation against ``flash_attention_pallas`` in interpret mode (K
    and V expanded to the query heads, [G, S, D]); rows with no key are 0 in
    both."""
    q, k, v = _flash_inputs(seed=1, s=128)
    kw = dict(scale=64 ** -0.5, causal=causal, window=window)
    got = ref.flash_attention_tf32_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    ke, ve = (np.repeat(x, 2, axis=1) for x in (k, v))
    want = flash_attention_pallas(*(jnp.asarray(x.reshape(-1, 128, 64)) for x in (q, ke, ve)),
                                  block_q=64, block_kv=64, interpret=True, **kw)
    assert _rel(got.reshape(-1, 128, 64), want) <= LIMIT


def test_flash_tf32_rows_with_no_key_are_zero():
    """Sq > Skv with a window: the rows the masks leave no key give exact 0."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(seed=2, s=64))
    got = ref.flash_attention_tf32_ref(q, k[:, :, :32], v[:, :, :32], scale=0.125, causal=True,
                                       window=8)
    assert not got[:, :, 39:].any() and got[:, :, :39].abs().amax(-1).min() > 0
    assert torch.isfinite(got).all()


# the bf16 route off TMA: D 5 (pieces of two bytes) and 100 (eight), ragged
# (Sq, Skv) ending inside the kernel's 64-key tiles, Sq > Skv (rows with no
# key under the window) and Skv > Sq
BF16_CASES = [(5, 97, 97), (100, 70, 130), (5, 130, 70), (100, 97, 97)]
BF16_U = 2.0 ** -8   # bf16's unit roundoff: rounding moves x by at most 2**-8 |x|


def _bf16_inputs(d, sq, skv, seed=0, h=4, hkv=2):
    """q, k, v as numpy fp32 holding bf16 values ([1, H, Sq, D] /
    [1, Hkv, Skv, D]); q scaled so the scores reach ~10."""
    rng = np.random.default_rng(seed)
    q = 3 * rng.standard_normal((1, h, sq, d)) / np.sqrt(d)
    k, v = (rng.standard_normal((1, hkv, skv, d)) for _ in range(2))
    return tuple(x.astype(ml_dtypes.bfloat16).astype(np.float32) for x in (q, k, v))


def _beyond_rounding(got, want) -> float:
    """max(|bf16(got) - want| - 2^-8 |want|) / max |want|: the error of a
    bf16 output beyond its own rounding (chip_smoke.py's hold_rounded)."""
    return (((got.bfloat16().double() - want).abs() - BF16_U * want.abs()).max()
            / want.abs().max()).item()


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("d,sq,skv", BF16_CASES)
def test_flash_bf16_split_beyond_rounding_one_rounding_is_not(d, sq, skv, causal, window):
    """GQA (4 query heads over 2 KV heads) on bf16 values: the weights in two
    bf16 parts give a bf16 output within 1e-5 of max |o| of the plain
    version in fp64 beyond bf16's output rounding; rounded once (the TPU
    kernel's choice) they do not where the scores reach ~10. Rows with no
    key are exactly 0."""
    q, k, v = (torch.from_numpy(x) for x in _bf16_inputs(d, sq, skv))
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    got = {parts: ref.flash_attention_bf16_split_ref(q, k, v, parts=parts, **kw)
           for parts in (2, 1)}
    errs = {parts: _beyond_rounding(o, want) for parts, o in got.items()}
    assert errs[2] <= LIMIT, errs
    assert errs[1] > LIMIT, errs
    qi, ki = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    empty = ~keep.any(-1)
    assert not got[2][:, :, empty].any() and torch.isfinite(got[2]).all()


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("d,sq,skv", BF16_CASES)
def test_flash_bf16_split_emulation_matches_jax_pallas(d, sq, skv, causal, window):
    """The emulation against ``flash_attention_pallas`` in interpret mode on
    the same bf16 inputs (K and V expanded to the query heads, [G, S, D];
    its weights rounded once to bf16, its output bf16): within bf16's 2e-2."""
    q, k, v = _bf16_inputs(d, sq, skv, seed=1)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    got = ref.flash_attention_bf16_split_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    ke, ve = (np.repeat(x, 2, axis=1) for x in (k, v))
    want = flash_attention_pallas(
        *(jnp.asarray(x.reshape(-1, x.shape[2], d), jnp.bfloat16) for x in (q, ke, ve)),
        block_q=sq, block_kv=skv, interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    torch.testing.assert_close(got.reshape(want.shape), want, atol=2e-2, rtol=2e-2)


def _causal_inputs(seed, h=2, m=64, t=512, d=16):
    """fp32 q [H, M, D], k, v [1, H, T, D]; q scaled so |s| reaches ~10."""
    rng = np.random.default_rng(seed)
    q = (3 * rng.standard_normal((h, m, d)) / np.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((1, h, t, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def test_causal_tf32_split_meets_the_fp32_limit_one_rounding_does_not():
    """The numeric choice of the causal kernel's fp32 route
    (causal_tf32_kernel, 32-token tiles): on fp32 operands (B=1, H=2, M=64,
    T=512, D=16) every operand and intermediate in two TF32 parts, three
    products each, lands within 1e-5 of max |y| of the plain version in
    fp64; one TF32 rounding of each does not."""
    q, k, v = (torch.from_numpy(x) for x in _causal_inputs(13))
    want = ref.flare_causal_chunk_ref(q.double(), k.double(), v.double(), tile=256)
    errs = {parts: _rel(ref.flare_causal_split_ref(q, k, v, tile=32, parts=parts,
                                                   split="tf32"), want)
            for parts in (2, 1)}
    assert errs[2] <= LIMIT, errs
    assert errs[1] > LIMIT, errs


def test_causal_tf32_emulation_matches_jax_pallas():
    """The emulation against ``flare_causal_chunk_pallas`` in interpret mode
    on the same fp32 inputs (the latents shared by the batch's groups): within
    the causal kernel's atol of 2e-5."""
    q, k, v = _causal_inputs(14)
    got = ref.flare_causal_split_ref(*(torch.from_numpy(x) for x in (q, k, v)), tile=32,
                                     split="tf32")
    want = flare_causal_chunk_pallas(jnp.asarray(q), *(jnp.asarray(x[0]) for x in (k, v)),
                                     tile=256, interpret=True)
    err = (got[0].double() - torch.from_numpy(np.array(want)).double()).abs().max().item()
    assert err <= 2e-5, err


MLA_SHAPES = {"deepseek": (16, 512, 64), "minicpm3": (40, 256, 32)}


def _mla_inputs(g, d, d2, page_dtype, seed=0):
    """numpy inputs of MLA's read: fp32 q [B, 1, G, D] and q2, one page head of
    latents [NB, 16, 1, D] and rotary keys (fp32, bf16 values, or int8 / e4m3
    with per-row fp32 scales), a shuffled page table, lanes of 0, a partial page,
    a mid-tile length and several pages; q scaled so the scores reach ~10."""
    rng = np.random.default_rng(seed)
    b, block, p = 4, 16, 6
    nb = b * p + 1
    lengths = np.array([0, 9, 53, 96], np.int32)
    pt = rng.permutation(nb - 1)[: b * p].reshape(b, p).astype(np.int32)
    q = (3 * rng.standard_normal((b, 1, g, d)) / np.sqrt(d)).astype(np.float32)
    q2 = (rng.standard_normal((b, 1, g, d2)) / np.sqrt(d2)).astype(np.float32)
    c = rng.standard_normal((nb, block, 1, d)).astype(np.float32)
    kr = rng.standard_normal((nb, block, 1, d2)).astype(np.float32)
    scales = {}
    if page_dtype == "bfloat16":
        c, kr = (x.astype(ml_dtypes.bfloat16) for x in (c, kr))
    elif page_dtype != "float32":
        def quant(x):
            top = 127.0 if page_dtype == "int8" else 448.0
            sc = np.maximum(np.abs(x).max(-1), 1e-6) / top
            y = x / sc[..., None]
            y = np.round(y).astype(np.int8) if page_dtype == "int8" else \
                y.astype(ml_dtypes.float8_e4m3fn)
            return y, sc.astype(np.float32)
        (c, cs), (kr, krs) = quant(c), quant(kr)
        scales = {"k_scale": cs, "v_scale": cs, "k2_scale": krs}
    return dict(q=q, q2=q2, c=c, kr=kr, pt=pt, lengths=lengths, **scales)


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int32)).to(torch.int16).view(
            torch.bfloat16)
    if x.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(x)


def _mla_kw(inp, conv):
    kw = {"q2": conv(inp["q2"]), "k2_pages": conv(inp["kr"])}
    kw.update({name: conv(inp[name]) for name in ("k_scale", "v_scale", "k2_scale") if name in inp})
    return kw


@pytest.mark.parametrize("page_dtype", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(MLA_SHAPES))
def test_mla_split_meets_the_fp32_limit_one_rounding_does_not(shape, page_dtype):
    """DeepSeek-V2-Lite's and MiniCPM3's read shapes: q in three bf16 parts
    and P in two within 1e-5 of max |o| of the plain version in fp64; q and
    P each rounded once to bf16 beyond it. A lane of length 0 gives 0."""
    inp = _mla_inputs(*MLA_SHAPES[shape], page_dtype)
    kw = _mla_kw(inp, _torch)
    q, c, pt, lengths = (_torch(inp[n]) for n in ("q", "c", "pt", "lengths"))
    wide = {n: t.double() if n == "q2" else t for n, t in kw.items()}
    want = ref.paged_attention_ref(q.double(), c, c, pt, lengths, scale=0.1,
                                   out_dtype=torch.float64, **wide)
    errs = {}
    for parts in ((3, 2), (1, 1)):
        got = ref.paged_mla_split_ref(q, c, pt, lengths, scale=0.1, q_parts=parts[0],
                                      p_parts=parts[1], **kw)
        assert not got[0].any() and torch.isfinite(got).all()
        errs[parts] = _rel(got, want)
    assert errs[(3, 2)] <= LIMIT, errs
    assert errs[(1, 1)] > LIMIT, errs


@pytest.mark.parametrize("page_dtype", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(MLA_SHAPES))
def test_mla_split_emulation_matches_jax_paged_attention(shape, page_dtype):
    """The emulation against the JAX ``paged_attention`` in interpret mode on
    the same numpy inputs (the latents both K and V, q2 over k_rope, the
    scales of int8 / fp8 pages)."""
    inp = _mla_inputs(*MLA_SHAPES[shape], page_dtype, seed=1)
    q, c, pt, lengths = (_torch(inp[n]) for n in ("q", "c", "pt", "lengths"))
    got = ref.paged_mla_split_ref(q, c, pt, lengths, scale=0.1, **_mla_kw(inp, _torch))
    jc = jnp.asarray(inp["c"])
    want = jpaged_attention(jnp.asarray(inp["q"]), jc, jc, jnp.asarray(inp["pt"]),
                            jnp.asarray(inp["lengths"]), scale=0.1, out_dtype=jnp.float32,
                            interpret=True, **_mla_kw(inp, jnp.asarray))
    assert _rel(got, want) <= LIMIT


@pytest.mark.parametrize("separate_v", [False, True])
@pytest.mark.parametrize("shape", list(MLA_SHAPES))
def test_mla_tf32_split_meets_the_fp32_limit_one_rounding_does_not(shape, separate_v):
    """The fp32-pages read (paged_mla_tf32_kernel) at DeepSeek-V2-Lite's and
    MiniCPM3's shapes, the latents both K and V or V its own pages: q, the
    pages and P in two TF32 parts within 1e-5 of max |o| of the plain
    version in fp64; each rounded once to TF32 beyond it. A lane of length 0
    gives 0, and the NaN in every row past a lane's length stays unseen."""
    inp = _mla_inputs(*MLA_SHAPES[shape], "float32")
    q, c, pt, lengths = (_torch(inp[n]) for n in ("q", "c", "pt", "lengths"))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(c.shape).astype(np.float32))
    v = v if separate_v else c
    for lane, n in enumerate(lengths.tolist()):   # NaN in every row past a lane's length
        for t in range(n, pt.shape[1] * c.shape[1]):
            c[pt[lane, t // c.shape[1]], t % c.shape[1]] = float("nan")
            v[pt[lane, t // c.shape[1]], t % c.shape[1]] = float("nan")
    kw = _mla_kw(inp, _torch)
    want = ref.paged_attention_ref(q.double(), c, v, pt, lengths, scale=0.1,
                                   out_dtype=torch.float64, **{**kw, "q2": kw["q2"].double()})
    errs = {}
    for parts in (2, 1):
        got = ref.paged_mla_tf32_ref(q, c, pt, lengths, scale=0.1, v_pages=v, parts=parts, **kw)
        assert not got[0].any() and torch.isfinite(got).all()
        errs[parts] = _rel(got, want)
    assert errs[2] <= LIMIT, errs
    assert errs[1] > LIMIT, errs


@pytest.mark.parametrize("shape", list(MLA_SHAPES))
def test_mla_tf32_emulation_matches_jax_paged_attention(shape):
    """The fp32-pages emulation against the JAX ``paged_attention`` in
    interpret mode on the same numpy inputs (the latents both K and V, q2
    over k_rope)."""
    inp = _mla_inputs(*MLA_SHAPES[shape], "float32", seed=1)
    q, c, pt, lengths = (_torch(inp[n]) for n in ("q", "c", "pt", "lengths"))
    got = ref.paged_mla_tf32_ref(q, c, pt, lengths, scale=0.1, **_mla_kw(inp, _torch))
    jc = jnp.asarray(inp["c"])
    want = jpaged_attention(jnp.asarray(inp["q"]), jc, jc, jnp.asarray(inp["pt"]),
                            jnp.asarray(inp["lengths"]), scale=0.1, out_dtype=jnp.float32,
                            interpret=True, **_mla_kw(inp, jnp.asarray))
    assert _rel(got, want) <= LIMIT


def test_one_byte_pages_widen_to_bf16_exactly():
    """Every int8 value and every finite e4m3 value is a bf16 value: the
    kernel's widening of one-byte rows to bf16 (through fp32) loses nothing."""
    i8 = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    fp8 = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(torch.float8_e4m3fn)
    fp8 = fp8[torch.isfinite(fp8.float())]
    for x in (i8, fp8):
        wide = x.float()
        assert torch.equal(wide.to(torch.bfloat16).float(), wide)
    assert fp8.numel() == 254 and fp8.float().abs().max() == 448


def test_three_bf16_parts_give_fp32_back_exactly():
    """q = p0 + p1 + p2 exactly over fp32 values of many magnitudes; two
    parts do not; a bf16-valued q has p1 = p2 = 0 (the kernel's skip)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    p0, p1, p2 = ref.bf16_split3(x)
    assert torch.equal(p0.double() + p1.double() + p2.double(), x.double())
    assert not torch.equal(p0.double() + p1.double(), x.double())
    b0, b1, b2 = ref.bf16_split3(x.bfloat16().float())
    assert not b1.any() and not b2.any()


@pytest.mark.parametrize("case,want", [
    ((16, 512, "bfloat16", True), "mla_tc"), ((40, 256, "int8", True), "mla_tc"),
    ((40, 256, "float8_e4m3fn", True), "mla_tc"), ((16, 512, "float32", True), "mla_tf32"),
    ((6, 128, "bfloat16", False), "decode"), ((2048, 8, "float32", False), "encode"),
    ((2048, 8, "float32", True), "decode")])
def test_paged_route_picks_the_instance_from_shape_and_page_dtype(case, want):
    """The instance the paged kernel's entry point runs, as the wrapper
    counts it: MLA's read (D > 128) on the bf16 tensor cores for bf16, int8
    and fp8 pages and on the TF32 tensor cores for fp32 pages; the FLARE encode for
    G > 32 at D <= 32 without q2; the decode read otherwise."""
    from repro_torch.kernels.paged_attention import paged_route

    g, d, dtype, with_q2 = case
    q = torch.zeros(1, 1, g, d)
    pages = torch.zeros(2, 16, 1, d).to(getattr(torch, dtype))
    assert paged_route(q, pages, torch.zeros(1, 1, g, 8) if with_q2 else None) == want
