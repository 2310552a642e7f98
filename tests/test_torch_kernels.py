"""The kernels' plain versions against the JAX package's kernels.

On CPU tensors every wrapper in ``repro_torch.kernels`` runs its plain
version, which is what these tests hold against the Pallas kernels, run in
interpret mode as the JAX tests run them. Tolerances: fp32 atol 1e-5
(tests/test_kernels.py), bf16 2e-2; the fused backward 1e-4 of the largest
gradient (tests/test_packed.py). The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flare import flare_decode_pallas, flare_encode_pallas
from repro.kernels.flare_packed import flare_mixer_packed
from repro_torch.core.dispatch import MixerPlan
from repro_torch.core.policy import run_plan
from repro_torch.kernels import ref
from repro_torch.kernels.flare import flare_decode, flare_encode
from repro_torch.kernels.flare_causal import flare_causal_chunk
from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd
from repro_torch.kernels.ops import flare_mixer_fused, launch_counts

# (B, H, M, N, D): ragged N and M=16, the paper's width at a short N
SHAPES = [(2, 4, 16, 97, 8), (1, 8, 2048, 300, 8), (2, 3, 24, 64, 4)]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(b, h, m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((h, m, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k, v


def _t(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _j(x, dtype):
    return jnp.asarray(x, dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("grouped_q", [True, False], ids=["q_per_head", "q_per_group"])
def test_encode_matches_pallas(shape, dtype, grouped_q):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    kg, vg = k.reshape(b * h, n, d), v.reshape(b * h, n, d)
    qg = q if grouped_q else np.tile(q, (b, 1, 1))        # Gq = H or Gq = G
    want = flare_encode_pallas(_j(qg, jdt), _j(kg, jdt), _j(vg, jdt), block_n=n,
                               block_m=min(128, m), interpret=True)
    # the port takes the per-head layout: q [H, M, D], k/v [B, H, N, D]
    got = flare_encode(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.shape == (b, h, m, d) and got.dtype == tdt
    _close(got.reshape(b * h, m, d), want, atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_matches_pallas(shape, dtype):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    kg = k.reshape(b * h, n, d)
    z = np.random.default_rng(1).standard_normal((b * h, m, d)).astype(np.float32)
    want = flare_decode_pallas(_j(q, jdt), _j(kg, jdt), _j(z, jdt), block_n=n, interpret=True)
    got = flare_decode(_t(q, tdt), _t(k, tdt), _t(z.reshape(b, h, m, d), tdt))
    assert got.shape == (b, h, n, d) and got.dtype == tdt
    _close(got.reshape(b * h, n, d), want, atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_strided_views_match_contiguous(shape):
    """[B, H, N, D] views of [B, N, H, D] storage (the model's split heads)
    give what contiguous operands give, for every wrapper."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(*shape))
    kv = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)   # [B,N,H,D] storage
    z = flare_encode(q, k, v)
    torch.testing.assert_close(flare_encode(q, kv(k), kv(v)), z, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(flare_decode(q, kv(k), z), flare_decode(q, k, z),
                               atol=1e-6, rtol=1e-6)
    for got, want in zip(flare_fused_fwd(q, kv(k), kv(v)), flare_fused_fwd(q, k, v)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_fwd_matches_packed_and_definitions(shape, dtype):
    b, h, m, n, d = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(*shape)
    y, z, mx, den, lse = flare_fused_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert y.dtype == tdt and z.dtype == mx.dtype == den.dtype == lse.dtype == torch.float32
    _close(y, flare_mixer_packed(_j(q, jdt), _j(k, jdt), _j(v, jdt)), atol)
    # the residuals, by their definitions through the JAX reference
    qj = _j(q, jdt).astype(jnp.float32)
    kj, vj = (_j(x, jdt).astype(jnp.float32).reshape(b * h, n, d) for x in (k, v))
    qg = jnp.tile(qj, (b, 1, 1))
    _close(z.reshape(b * h, m, d), jref.flare_encode_ref(qg, kj, vj), 1e-5)
    s = jnp.einsum("gmd,gnd->gmn", qg, kj)
    smax = jnp.max(s, axis=-1)
    _close(mx.reshape(b * h, m), smax, 1e-5)
    _close(den.reshape(b * h, m), jnp.sum(jnp.exp(s - smax[..., None]), axis=-1), 1e-5)
    _close(lse.reshape(b * h, n), jax.nn.logsumexp(s, axis=1), 1e-5)


# (B, H, M, N, D): ragged N and M (M=20 is not a multiple of 16), B > 1 so
# that dq's batch sum is covered
BWD_SHAPES = [(2, 4, 16, 97, 8), (3, 2, 20, 45, 4), (2, 3, 24, 64, 8)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_fused_bwd_matches_jax_grad_of_packed(shape):
    """The plain fused backward against jax.grad of the JAX packed mixer (its
    custom VJP, the Pallas backward kernel in interpret mode), at 1e-4 of the
    largest gradient."""
    b, h, m, n, d = shape
    q, k, v = _inputs(*shape)
    dy = np.random.default_rng(2).standard_normal((b, h, n, d)).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(jnp.asarray(dy) * flare_mixer_packed(
        q_, k_, v_, block_n=32)), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt, dyt = map(torch.from_numpy, (q, k, v, dy))
    before = launch_counts()
    y, *res = flare_fused_fwd(qt, kt, vt)
    got = flare_fused_bwd(qt, kt, vt, *res, y, dyt)
    assert launch_counts() == before
    for g, w, s in zip(got, want, ((h, m, d), (b, h, n, d), (b, h, n, d))):
        assert g.shape == s and g.dtype == torch.float32
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 16, 40])
def test_fused_bwd_chunked_matches_whole(chunk):
    """Taking the tokens in chunks changes only the order of the sums."""
    q, k, v = (torch.from_numpy(x).double() for x in _inputs(2, 3, 24, 97, 8))
    dy = torch.randn(k.shape, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    y, *res = ref.flare_fused_fwd_ref(q, k, v)
    whole = ref.flare_fused_bwd_ref(q, k, v, *res, y, dy)
    for got, want in zip(ref.flare_fused_bwd_ref(q, k, v, *res, y, dy, chunk=chunk), whole):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def _mm_tf32(a, b, split: bool):
    """a @ b as the backward kernel's tensor cores form it from fp32
    operands: TF32 parts (exact products, fp32 sums), lo.hi + hi.lo + hi.hi
    where ``split``, else hi.hi alone (one rounding of each operand)."""
    ah, al = ref.tf32_split(a)
    bh, bl = ref.tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh if split else ah @ bh


def _bwd_on_tensor_cores(q, k, v, z, mx, den, lse, y, dy, split: bool):
    """One (b, h) group's backward with every product through _mm_tf32, the
    weights and dS in fp32: q, z [M, D]; k, v, y, dy [N, D]; mx, den [M];
    lse [N] -> (dq [M, D], dk, dv [N, D])."""
    s = _mm_tf32(q, k.T, split)
    w = torch.exp(s - lse[None, :])
    a = torch.exp(s - (mx + den.log())[:, None])
    dz = _mm_tf32(w, dy, split)
    de, dd = (dz * z).sum(-1), (dy * y).sum(-1)
    ds = a * (_mm_tf32(dz, v.T, split) - de[:, None]) + w * (_mm_tf32(z, dy.T, split) - dd)
    return _mm_tf32(ds, k, split), _mm_tf32(ds.T, q, split), _mm_tf32(a.T, dz, split)


def test_tf32_three_way_split_meets_the_fp32_limit_one_rounding_does_not():
    """The numeric choice of the backward kernel (csrc/flare_bwd.cu): at a
    small FLARE shape (D=8, M=256, N=4,096), its products on TF32 operands
    split three ways stay within 1e-5 of each gradient's max |.| of the fp64
    backward (chip_smoke.py's RTOL), and on singly rounded operands they do
    not."""
    rng = np.random.default_rng(18)
    m, n, d = 256, 4096, 8
    q = rng.standard_normal((1, m, d)) / np.sqrt(d)
    k, v, dy = (rng.standard_normal((1, 1, n, d)) for _ in range(3))
    q64, k64, v64, dy64 = (torch.from_numpy(x) for x in (q, k, v, dy))
    y64, *res64 = ref.flare_fused_fwd_ref(q64, k64, v64)
    want = ref.flare_fused_bwd_ref(q64, k64, v64, *res64, y64, dy64)
    z, mx, den, lse = (t.float()[0, 0] for t in res64)
    ops = (q64.float()[0], k64.float()[0, 0], v64.float()[0, 0], z, mx, den, lse,
           y64.float()[0, 0], dy64.float()[0, 0])
    assert ref.tf32(torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1.0]   # to nearest, ties away from zero
    errs = {}
    for split in (True, False):
        got = _bwd_on_tensor_cores(*ops, split=split)
        errs[split] = [((g.double() - w.reshape(g.shape)).abs().max()
                        / w.abs().max()).item() for g, w in zip(got, want)]
    assert max(errs[True]) <= 1e-5, errs
    assert min(errs[False]) > 1e-5, errs


def _fwd_on_tensor_cores(q, k, v, split: bool):
    """One (b, h) group's forward as csrc/flare.cu forms it: the scores and
    the weighted sums P v and W Z through _mm_tf32, the weights and their
    sums in fp32: q [M, D]; k, v [N, D] -> (z [M, D], y [N, D])."""
    s = _mm_tf32(q, k.T, split)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    z = _mm_tf32(p, v, split) / p.sum(-1, keepdim=True)
    st = _mm_tf32(k, q.T, split)
    w = torch.exp(st - st.amax(-1, keepdim=True))
    return z, _mm_tf32(w, z, split) / w.sum(-1, keepdim=True)


def test_forward_tf32_three_way_split_meets_the_fp32_limit_one_rounding_does_not():
    """The numeric choice of the forward kernels (csrc/flare.cu): at D=8,
    M=256, N=4,096, the encode's P v and the decode's W Z (and the scores)
    on TF32 operands split three ways stay within 1e-5 of max |.| of the
    fp64 encode and of the fp64 decode of the same Z (chip_smoke.py's
    RTOL); on singly rounded operands they do not."""
    rng = np.random.default_rng(19)
    m, n, d = 256, 4096, 8
    q = torch.from_numpy(rng.standard_normal((1, m, d)) / np.sqrt(d))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, n, d))) for _ in range(2))
    z64 = ref.flare_encode_ref(q, k, v)[0, 0]
    errs = {}
    for split in (True, False):
        z, y = _fwd_on_tensor_cores(q.float()[0], k.float()[0, 0], v.float()[0, 0], split)
        y64 = ref.flare_decode_ref(q, k, z.double()[None, None])[0, 0]
        errs[split] = [((got.double() - want).abs().max() / want.abs().max()).item()
                       for got, want in ((z, z64), (y, y64))]
    assert max(errs[True]) <= 1e-5, errs
    assert min(errs[False]) > 1e-5, errs


def test_causal_bf16_two_part_split_meets_the_limit_one_rounding_does_not():
    """The numeric choice of the causal kernel's bf16 route (csrc/flare_causal.cu,
    causal_tc_kernel): on bf16-valued operands (B=1, H=2, M=64, T=512,
    D=16), f1, f2, the intra-tile mixing and the carried numerator in two
    bf16 parts give a bf16 output within 1e-5 of max |y| of the fp64 plain
    version beyond bf16's output rounding (chip_smoke.py's hold_rounded:
    max(|y - want| - 2^-8 |want|)); rounded once to bf16 they do not. The
    scores are scaled up (|s| to ~10), as a trained model's are."""
    rng = np.random.default_rng(13)
    h, m, t, d = 2, 64, 512, 16
    q = torch.from_numpy(3 * rng.standard_normal((h, m, d)) / np.sqrt(d)).bfloat16().double()
    k, v = (torch.from_numpy(rng.standard_normal((1, h, t, d))).bfloat16().double()
            for _ in range(2))
    want = ref.flare_causal_chunk_ref(q, k, v, tile=256)
    scale = want.abs().max()

    def beyond_rounding(y):
        return (((y.bfloat16().double() - want).abs() - 2.0 ** -8 * want.abs()).max()
                / scale).item()

    errs = {parts: beyond_rounding(ref.flare_causal_split_ref(q.float(), k.float(), v.float(),
                                                              parts=parts))
            for parts in (2, 1)}
    assert [x.item() for x in ref.bf16_split(torch.tensor([1 + 2 ** -9 + 2 ** -20]))] == [
        1.0, 2 ** -9]   # hi to nearest, lo the rest to nearest
    assert errs[2] <= 1e-5, errs
    assert errs[1] > 1e-5, errs


def test_plain_mixer_matches_jax_reference():
    q, k, v = _inputs(2, 4, 16, 97, 8)
    want = jref.flare_mixer_ref(*(jnp.asarray(x) for x in (np.tile(q, (2, 1, 1)),
                                                           k.reshape(8, 97, 8), v.reshape(8, 97, 8))))
    got = ref.flare_mixer_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got.reshape(8, 97, 8), want, 1e-5)


@pytest.mark.parametrize("backend", ["pallas", "packed"])
def test_kernel_backends_take_plain_path_on_cpu(backend):
    """On CPU tensors the kernel backends run the plain versions: same result,
    no launch counted."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 16, 97, 8))
    before = launch_counts()
    y = run_plan(MixerPlan(backend), q, k, v)
    torch.testing.assert_close(y, ref.flare_mixer_ref(q, k, v), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(flare_mixer_fused(q, k, v), y, atol=1e-5, rtol=1e-5)
    assert launch_counts() == before


@pytest.mark.parametrize("call", ["encode", "decode", "fused", "fused_bwd", "pallas_backend",
                                  "causal", "causal_pallas_backend"])
def test_grad_requiring_call_raises(call):
    """The raw wrappers and the kernel-route backends are forward-only;
    autograd goes through the packed backend (test_packed_backend_differentiates)
    or, on the causal path, the plain causal_stream."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 33, 8))
    with torch.no_grad():
        y, *res = flare_fused_fwd(q, k, v)
    q.requires_grad_(True)
    fns = {"encode": lambda: flare_encode(q, k, v),
           "decode": lambda: flare_decode(q, k, torch.zeros(1, 2, 16, 8)),
           "fused": lambda: flare_fused_fwd(q, k, v),
           "fused_bwd": lambda: flare_fused_bwd(q, k, v, *res, y, torch.ones_like(y)),
           "pallas_backend": lambda: run_plan(MixerPlan("pallas"), q, k, v),
           "causal": lambda: flare_causal_chunk(q, k, v),
           "causal_pallas_backend": lambda: run_plan(MixerPlan("causal_pallas"), q, k, v)}
    with pytest.raises(RuntimeError, match="forward-only"):
        fns[call]()
    with torch.no_grad():
        fns[call]()   # inference is fine


def test_packed_backend_differentiates():
    """The packed backend runs through FlareFused: under autograd its
    gradients are the plain backward's, and no kernel launches on the CPU."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(2, 2, 16, 33, 8))
    before = launch_counts()
    y = run_plan(MixerPlan("packed"), q, k, v)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    y.backward(dy)
    assert launch_counts() == before
    with torch.no_grad():
        y0, *res = flare_fused_fwd(q, k, v)
        want = flare_fused_bwd(q, k, v, *res, y0, dy)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-6)


def test_wrappers_reject_bad_operands():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 33, 8))
    with pytest.raises(ValueError, match="expected"):
        flare_encode(q, k[:, :1], v[:, :1])                    # head count differs
    with pytest.raises(ValueError, match="dtype"):
        flare_fused_fwd(q, k, v.double())
    with pytest.raises(ValueError, match="expected"):
        flare_encode(q, k.reshape(2, 33, 8), v.reshape(2, 33, 8))   # the Pallas [G, N, D]
    with pytest.raises(ValueError, match="z must be"):
        flare_decode(q, k, torch.zeros(2, 16, 8))
    with pytest.raises(ValueError, match="no kernel for device"):
        flare_fused_fwd(*(x.to("meta") for x in (q, k, v)))
    with pytest.raises(ValueError, match="empty"):
        flare_fused_fwd(q, k[:, :, :0], v[:, :, :0])
    y, z, mx, den, lse = flare_fused_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        flare_fused_bwd(q, k, v, z, mx, den, lse[:, :, 1:], y, y)
    with pytest.raises(ValueError, match="z must be"):
        flare_fused_bwd(q, k, v, z[:, :1], mx, den, lse, y, y)


# --- paged attention ------------------------------------------------------------


def _paged_inputs(b=3, h=2, g=4, d=16, nb=9, block=8, p=4, quant=None, q2=False, seed=0):
    """Random operands of the JAX paged kernel's tests: a shuffled page table
    (the trash row among its targets), a zero-length lane and a partial page;
    ``quant`` "int8" or "fp8" stores the pages quantized with per-row scales
    (the serving pool's), dequantized by the kernel."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((nb, block, h, d)).astype(np.float32)
    v = rng.standard_normal((nb, block, h, d)).astype(np.float32)
    ops = {"q": rng.standard_normal((b, h, g, d)).astype(np.float32),
           "page_table": rng.integers(0, nb, (b, p)).astype(np.int32),
           "lengths": np.asarray([0, 13, p * block][:b], np.int32)}
    if quant is not None:
        from repro_torch.serve.pool.quant import get_quant, quantize

        spec = get_quant(quant)
        (kq, ks), (vq, vs) = (quantize(spec, torch.from_numpy(x)) for x in (k, v))
        # the JAX oracle takes the payload widened to fp32: exact for int8 and fp8
        k, v = kq.float().numpy(), vq.float().numpy()
        ops.update(k_scale=ks.numpy(), v_scale=vs.numpy())
    ops.update(k_pages=k, v_pages=v)
    if q2:
        ops["q2"] = rng.standard_normal((b, h, g, 8)).astype(np.float32)
        ops["k2_pages"] = rng.standard_normal((nb, block, h, 8)).astype(np.float32)
        ops["k2_scale"] = (1 + 0.1 * rng.standard_normal((nb, block, h))).astype(np.float32)
    return ops


PAGED_CASES = {"g4": {}, "g1": dict(g=1), "int8": dict(quant="int8"), "fp8": dict(quant="fp8"),
               "q2_k2": dict(q2=True), "g1_int8_q2": dict(g=1, quant="int8", q2=True),
               "d96": dict(g=1, d=96), "d24_int8": dict(d=24, quant="int8")}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_matches_jax_oracle_and_pallas(case):
    """The plain version (what the wrapper runs on CPU tensors) against the
    JAX oracle and the Pallas kernel in interpret mode, as
    tests/test_paged_pool.py runs them: fp32 atol 2e-6. The zero-length lane
    returns exact zeros."""
    from repro.kernels.paged_attention import paged_attention as jpaged
    from repro.kernels.paged_attention import paged_attention_ref as jpaged_ref
    from repro_torch.kernels.paged_attention import paged_attention

    ops = _paged_inputs(**PAGED_CASES[case])
    names = ("q", "k_pages", "v_pages", "page_table", "lengths")
    kw = {key: x for key, x in ops.items() if key not in names}
    jargs = [jnp.asarray(ops[n]) for n in names]
    jkw = {key: jnp.asarray(x) for key, x in kw.items()}
    oracle = jpaged_ref(*jargs, scale=0.5, **jkw)
    pallas = jpaged(*jargs, scale=0.5, interpret=True, **jkw)
    before = launch_counts()
    got = paged_attention(*(torch.from_numpy(ops[n]) for n in names), scale=0.5,
                          **{key: torch.from_numpy(x) for key, x in kw.items()})
    assert launch_counts() == before and got.shape == ops["q"].shape
    for want in (oracle, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=2e-6)
    assert not got[0].any()


def test_paged_attention_plain_version_is_fp64_for_fp64_and_skips_garbage():
    """The plain version computes in fp64 for fp64 q, and rows past a lane's
    length (the trash row a page table points unmapped entries at, here
    non-finite) never reach the output."""
    from repro_torch.kernels.ref import paged_attention_ref

    ops = {key: torch.from_numpy(x) for key, x in _paged_inputs().items()}
    k, v = ops["k_pages"].clone(), ops["v_pages"].clone()
    pt = ops["page_table"].clone()
    pt[1, 2:] = 8                       # lane 1 (13 tokens) maps 2 pages; the rest is trash
    k[8], v[8] = float("nan"), float("inf")
    args = (ops["q"], k, v, pt, ops["lengths"])
    out = paged_attention_ref(*args, scale=0.5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    wide = paged_attention_ref(ops["q"].double(), k.double(), v.double(), *args[3:], scale=0.5)
    assert wide.dtype == torch.float64
    torch.testing.assert_close(out.double(), wide, atol=1e-6, rtol=1e-6)


def test_paged_attention_wrapper_checks_operands():
    from repro_torch.kernels.paged_attention import paged_attention

    ops = {key: torch.from_numpy(x) for key, x in _paged_inputs(quant="int8").items()}
    base = (ops["q"], ops["k_pages"], ops["v_pages"], ops["page_table"], ops["lengths"])
    with pytest.raises(ValueError, match="pages must be"):
        paged_attention(ops["q"], ops["k_pages"][:, :, :1], *base[2:])
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention(*base, k_scale=ops["k_scale"][:, :, :1])
    with pytest.raises(ValueError, match="come together"):
        paged_attention(*base, q2=ops["q"])
    with pytest.raises(RuntimeError, match="forward-only"):
        paged_attention(ops["q"].clone().requires_grad_(True), *base[1:])


def test_paged_backend_matches_sdpa():
    """The paged backend (the encode through the paged kernel's plain
    version, the decode plain) against sdpa: atol/rtol 1e-5, odd N padded
    into pages, no launch on the CPU."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 8, 19, 16))
    before = launch_counts()
    got = run_plan(MixerPlan("paged", {"block": 16}), q, k, v)
    torch.testing.assert_close(got, run_plan(MixerPlan("sdpa"), q, k, v), atol=1e-5, rtol=1e-5)
    assert launch_counts() == before


def test_paged_backend_policy_contract():
    """Registered bidirectional and forward-only; resolves by policy with a
    block, refuses a differentiated path, and scores 40 at the decode-read
    signature (latents == 1), where "auto" picks it on either device, but
    below every dense backend at M > 1."""
    from repro_torch.core.dispatch import MixerShape, get_backend
    from repro_torch.core.policy import MixerPolicy, resolve_policy

    b = get_backend("paged")
    assert b.caps.bidirectional and not b.caps.causal and not b.caps.grads
    shape = MixerShape(batch=1, heads=2, tokens=64, latents=8, head_dim=16)
    plan = resolve_policy(MixerPolicy(backends=("paged",)), shape, torch.float32, device="cpu")
    assert plan.backend == "paged" and plan.params == {"block": 16}
    with pytest.raises(ValueError, match="forward-only"):
        resolve_policy(MixerPolicy(backends=("paged",), requires_grad=True), shape,
                       torch.float32, device="cpu")
    decode = MixerShape(batch=8, heads=2, tokens=4096, latents=1, head_dim=128)
    assert b.score(decode, "cuda") == 40.0
    for device in ("cpu", "cuda"):
        assert resolve_policy(MixerPolicy(), decode, torch.bfloat16, device=device).backend == "paged"
        assert resolve_policy(MixerPolicy(), shape, torch.float32, device=device).backend != "paged"
