"""Plain PyTorch versions of the FLARE kernels (the allclose targets).

Counterpart of ``repro/kernels/ref.py``, in the port's per-head layout:
q ``[H, M, D]`` with k/v ``[B, H, N, D]`` (any strides). The latents are
indexed per head through the einsum, never broadcast. Scores and softmax
statistics are fp32 (fp64 for fp64 inputs, an exact yardstick); the outputs
take the input dtype, except the fused forward's residuals, which are fp32
(fp64) as the kernel keeps them. The fused backward takes the tokens in
chunks (``chunk=``), so that its [B, H, M, chunk] temporaries fit where the
whole [B, H, M, N] would not. The causal version sweeps the tokens in
tiles (``tile=``), the factored form of ``core/flare_stream.py``.
The paged-attention version gathers each lane's pages into a dense view,
as ``repro/kernels/paged_attention.py::paged_attention_ref`` does; the
split emulations beside the plain versions repeat the numeric choices of
the tensor-core kernels (TF32 or bf16 parts, exact products, fp32 sums). The
flash-attention version takes any leading dims (``[G, S, D]`` as in the JAX
package, or ``[B, H, S, D]``).
"""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in its own dtype where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, M, N] scores q k^T (scale 1, paper §3.2), at least fp32."""
    return torch.einsum("hmd,bhnd->bhmn", _wide(q), _wide(k))


def flare_encode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Encode: Z = softmax(q k^T) v over tokens -> [B, H, M, D] in v's dtype."""
    w = torch.softmax(_scores(q, k), dim=-1)
    return torch.einsum("bhmn,bhnd->bhmd", w, _wide(v)).to(v.dtype)


def flare_decode_ref(q: torch.Tensor, k: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Decode: Y = softmax over latents of (k q^T), applied to z [B, H, M, D]
    -> [B, H, N, D] in k's dtype."""
    w = torch.softmax(_scores(q, k), dim=-2)                   # over M
    return torch.einsum("bhmn,bhmd->bhnd", w, _wide(z)).to(k.dtype)


def flare_mixer_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Both SDPA calls, encode then decode."""
    return flare_decode_ref(q, k, flare_encode_ref(q, k, v))


def flare_fused_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The fused forward with its residuals, per head:
    q [H, M, D], k/v [B, H, N, D] -> (y [B, H, N, D] in v's dtype,
    Z [B, H, M, D], per-latent max and den [B, H, M], per-token decode
    log-sum-exp [B, H, N]; the residuals fp32, fp64 for fp64 inputs), where
    den = sum_n exp(s - max) and lse = log sum_m exp(s)."""
    s = _scores(q, k)
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    den = p.sum(dim=-1)
    z = torch.einsum("bhmn,bhnd->bhmd", p, _wide(v)) / den[..., None]
    del p   # at most two [B, H, M, N] tensors alive at a time
    lse = torch.logsumexp(s, dim=-2)
    y = torch.einsum("bhmn,bhmd->bhnd", torch.exp(s - lse[:, :, None]), z).to(v.dtype)
    return y, z, mx, den, lse


def flare_enc_stats_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """A rank's encode statistics over its tokens (the math of
    ``_enc_stats_kernel``): q [H, M, D], k/v [B, H, N, D] -> (num
    [B, H, M, D], mx [B, H, M], den [B, H, M]), fp32 (fp64 for fp64 inputs),
    where mx = max_n s, num = sum_n exp(s - mx) v_n, den = sum_n exp(s - mx):
    the numerator before the normalisation."""
    s = _scores(q, k)
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    return torch.einsum("bhmn,bhnd->bhmd", p, _wide(v)), mx, p.sum(dim=-1)


def combine_stats_ref(num: torch.Tensor, mx: torch.Tensor, den: torch.Tensor):
    """Merge S ranks' encode statistics stacked on a leading axis (num
    [S, B, H, M, D], mx and den [S, B, H, M]) -> (Z [B, H, M, D], the
    global max and den [B, H, M]): gmax = max mx,
    Z = sum num e^(mx - gmax) / sum den e^(mx - gmax)."""
    gmax = mx.amax(dim=0)
    scale = torch.exp(mx - gmax)
    gden = (den * scale).sum(dim=0)
    return (num * scale[..., None]).sum(dim=0) / gden[..., None], gmax, gden


def flare_decode_stats_ref(q: torch.Tensor, k: torch.Tensor, z: torch.Tensor):
    """The decode with each token's log-sum-exp over the latents (the
    sharded forward's decode against the merged Z): -> (y [B, H, N, D] in
    k's dtype, lse [B, H, N] fp32, fp64 for fp64 inputs)."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-2)
    y = torch.einsum("bhmn,bhmd->bhnd", torch.exp(s - lse[:, :, None]), _wide(z))
    return y.to(k.dtype), lse


def _chunks(n: int, chunk):
    step = n if chunk is None else chunk
    return [slice(n0, min(n, n0 + step)) for n0 in range(0, n, step)]


def flare_bwd_dz_ref(q, k, lse, dy, *, chunk=None) -> torch.Tensor:
    """First pass of the fused backward: dZ = W dy, W the decode weights
    exp(s - lse) -> [B, H, M, D] (fp32, fp64 for fp64 inputs)."""
    dz = 0
    for sl in _chunks(k.shape[2], chunk):
        w = torch.exp(_scores(q, k[:, :, sl]) - lse[:, :, None, sl])
        dz = dz + torch.einsum("bhmn,bhnd->bhmd", w, _wide(dy[:, :, sl]))
    return dz


def flare_bwd_grads_ref(q, k, v, z, mx, den, lse, y, dy, dz, *, chunk=None):
    """Second pass of the fused backward, given dZ: with A = exp(s - max) / den
    and W = exp(s - lse),
    dS = A (dZ v^T - rowsum(dZ Z)) + W (Z dy^T - rowsum(dy y)) and
    dq = sum_b dS k [H, M, D], dk = dS^T q, dv = A^T dZ [B, H, N, D]."""
    qw = _wide(q)
    le = mx + den.log()                                    # encode log-sum-exp
    de = (dz * z).sum(-1)                                  # [B, H, M]
    dq, dk, dv = 0, [], []
    for sl in _chunks(k.shape[2], chunk):
        kc, vc, dyc = _wide(k[:, :, sl]), _wide(v[:, :, sl]), _wide(dy[:, :, sl])
        dd = (dyc * _wide(y[:, :, sl])).sum(-1)            # [B, H, n]
        s = _scores(q, kc)
        a = torch.exp(s - le[..., None])
        w = torch.exp(s - lse[:, :, None, sl])
        ds = (a * (torch.einsum("bhmd,bhnd->bhmn", dz, vc) - de[..., None])
              + w * (torch.einsum("bhmd,bhnd->bhmn", z, dyc) - dd[:, :, None]))
        dq = dq + torch.einsum("bhmn,bhnd->hmd", ds, kc)
        dk.append(torch.einsum("bhmn,hmd->bhnd", ds, qw))
        dv.append(torch.einsum("bhmn,bhmd->bhnd", a, dz))
    return (dq.to(q.dtype), torch.cat(dk, dim=2).to(k.dtype), torch.cat(dv, dim=2).to(v.dtype))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, by bit arithmetic on the fp32 word, as ``cvt.rna.tf32.f32`` does:
    add half of the 13 dropped bits' unit to the magnitude, then clear them.
    Infinities and NaNs pass unchanged."""
    bits = x.to(torch.float32).view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x.to(torch.float32))


def tf32_split(x: torch.Tensor):
    """fp32 x as (hi, lo): hi = tf32(x), lo = tf32(x - hi), the two TF32
    parts the backward kernel's tensor-core products take; hi + lo is within
    about 2**-21 |x| of x."""
    hi = tf32(x)
    return hi, tf32(x.to(torch.float32) - hi)


def bf16_split(x: torch.Tensor):
    """x as (hi, lo): hi = bf16(x), lo = bf16(x - hi), both rounded to
    nearest even as ``__float2bfloat16_rn`` rounds, returned as fp32 tensors
    holding bf16 values: the two parts the causal kernel's bf16 tensor-core
    products take; hi + lo is within about 2**-17 |x| of x."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def bf16_split3(x: torch.Tensor):
    """fp32 x as three bf16 parts (p0, p1, p2), each rounded to nearest even
    from what the parts before it leave, returned as fp32 tensors holding
    bf16 values: the query parts of MLA's tensor-core read. Each part keeps
    8 significant bits, so p0 + p1 + p2 == x exactly for fp32 x of normal
    magnitude; a bf16-valued x has p1 = p2 = 0."""
    x = x.to(torch.float32)
    p0 = x.to(torch.bfloat16).to(torch.float32)
    r = x - p0
    p1 = r.to(torch.bfloat16).to(torch.float32)
    return p0, p1, (r - p1).to(torch.bfloat16).to(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """einsum ``eq`` of a and b as a TF32 tensor-core kernel takes it, fp32
    out: each operand in ``parts`` TF32 parts (2: hi + lo, the products lo.hi
    + hi.lo + hi.hi, never lo.lo; 1: hi alone), each product exact (fp64)."""
    (ah, *al), (bh, *bl) = (tf32_split(x)[:parts] for x in (a, b))
    pairs = [(x, bh) for x in al] + [(ah, y) for y in bl] + [(ah, bh)]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in pairs).float()


def flash_attention_tf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             scale: float, causal: bool = True, window=None,
                             parts: int = 2) -> torch.Tensor:
    """The fp32 flash route with the products of its TF32 tensor-core kernel
    (``csrc/flash_attention.cu::flash_tf32_kernel``) emulated: q, k, v and
    the weights enter S = q k^T and P V as TF32 parts (``parts=2``: hi + lo,
    the products lo.hi + hi.lo + hi.hi, the kernel's choice; ``parts=1``: hi
    alone, one rounding), the products exact, the scale, masks, max, weights
    and den fp32 (den clamped at 1e-30, so a row with no key gives 0). Over a
    whole row at once: the kernel's 32-key tiles and online rescaling change
    only the order of fp32 sums. q [..., H, Sq, D], k/v [..., Hkv, Skv, D]
    fp32 (Hkv | H) -> o [..., H, Sq, D] fp32."""
    if q.dim() >= 3 and k.shape[-3] != q.shape[-3]:
        groups = q.shape[-3] // k.shape[-3]
        k, v = (t.repeat_interleave(groups, dim=-3) for t in (k, v))
    mm = lambda eq, a, b: _tf32_product(eq, a, b, parts)
    sq, skv = q.shape[-2], k.shape[-2]
    s = mm("...sd,...td->...st", q, k) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    s = s.masked_fill(~keep, -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - torch.where(torch.isfinite(mx), mx, 0)), 0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return mm("...st,...td->...sd", p, v) / den


def paged_mla_split_ref(q, k_pages, page_table, lengths, *, scale: float = 1.0, k_scale=None,
                        v_scale=None, q2=None, k2_pages=None, k2_scale=None, q_parts: int = 3,
                        p_parts: int = 2) -> torch.Tensor:
    """MLA's paged read (the latents ``k_pages`` both K and V) with the
    products of its tensor-core kernel (``csrc/paged_attention.cu::
    paged_mla_tc_kernel``) emulated: the staged rows widened to bf16 (exact
    for bf16, int8 and e4m3 pages), q and q2 in ``q_parts`` bf16 parts (3:
    exactly fp32, the kernel's choice; 1: one rounding), the weights p times
    v_scale in ``p_parts`` bf16 parts (2: hi + lo, the kernel's; 1: one
    rounding); the products exact, the scores (dot x k_scale + rope term x
    k2_scale, x scale, the mask), softmax and den fp32. q [B, H, G, D] fp32,
    pages [NB, block, H, D] -> [B, H, G, D] fp32; a lane of length 0 gives 0."""
    c = _gather_rows(k_pages, page_table).float().to(torch.bfloat16).double()   # [B, H, T, D]
    t = c.shape[2]
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, :]          # [B, 1, T]
    c = c.masked_fill(~valid[..., None], 0)

    def qsum(x):
        return sum(p.double() for p in bf16_split3(x)[:q_parts])

    s = torch.einsum("bhgd,bhtd->bhgt", qsum(q), c).float()
    if k_scale is not None:
        s = s * _gather_rows(k_scale, page_table).float()[:, :, None, :]
    if q2 is not None:
        k2 = _gather_rows(k2_pages, page_table).float().to(torch.bfloat16).double()
        s2 = torch.einsum("bhgd,bhtd->bhgt", qsum(q2),
                          k2.masked_fill(~valid[..., None], 0)).float()
        if k2_scale is not None:
            s2 = s2 * _gather_rows(k2_scale, page_table).float()[:, :, None, :]
        s = s + s2
    s = (s * scale).masked_fill(~valid[:, :, None, :], -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        p = p * _gather_rows(v_scale, page_table).float()[:, :, None, :]
    hi, lo = bf16_split(p)
    pw = hi.double() + (lo.double() if p_parts == 2 else 0)
    return torch.einsum("bhgt,bhtd->bhgd", pw, c).float() / den


def paged_mla_tf32_ref(q, k_pages, page_table, lengths, *, scale: float = 1.0, v_pages=None,
                       k_scale=None, v_scale=None, q2=None, k2_pages=None, k2_scale=None,
                       parts: int = 2) -> torch.Tensor:
    """MLA's paged read over fp32 pages (the latents ``k_pages`` both K and
    V, or V its own ``v_pages``) with the products of its TF32 tensor-core
    kernel (``csrc/paged_attention.cu::paged_mla_tf32_kernel``) emulated: q,
    q2, the staged rows and the weights p times v_scale enter S = q c^T (+
    q2 k_rope^T) and P V as TF32 parts (``parts=2``: hi + lo, the products
    lo.hi + hi.lo + hi.hi, the kernel's choice; ``parts=1``: hi alone, one
    rounding), the products exact; the scores (dot x k_scale + rope term x
    k2_scale, x scale, the mask), softmax and den fp32. Over a whole lane at
    once: the kernel's 32-token tiles, online rescaling and page slices
    change only the order of fp32 sums. q [B, H, G, D] fp32, pages [NB,
    block, H, D] fp32 -> [B, H, G, D] fp32; a lane of length 0 gives 0."""
    mm = lambda eq, a, b: _tf32_product(eq, a, b, parts)
    t = page_table.shape[1] * k_pages.shape[1]
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, :]          # [B, 1, T]

    def rows(pages):   # rows past a lane's length zeroed, so garbage there is invisible
        return _gather_rows(pages, page_table).float().masked_fill(~valid[..., None], 0)

    s = mm("bhgd,bhtd->bhgt", q, rows(k_pages))
    if k_scale is not None:
        s = s * _gather_rows(k_scale, page_table).float()[:, :, None, :]
    if q2 is not None:
        s2 = mm("bhgd,bhtd->bhgt", q2, rows(k2_pages))
        if k2_scale is not None:
            s2 = s2 * _gather_rows(k2_scale, page_table).float()[:, :, None, :]
        s = s + s2
    s = (s * scale).masked_fill(~valid[:, :, None, :], -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        p = p * _gather_rows(v_scale, page_table).float()[:, :, None, :]
    v = rows(k_pages if v_pages is None else v_pages)
    return mm("bhgt,bhtd->bhgd", p, v) / den


def flare_fused_bwd_ref(q, k, v, z, mx, den, lse, y, dy, *, chunk=None):
    """The backward of the fused forward from its residuals (the math of
    ``_fused_bwd_kernel``): q [H, M, D]; k, v, y, dy [B, H, N, D]; z, mx,
    den, lse as :func:`flare_fused_fwd_ref` returns them ->
    (dq [H, M, D] summed over the batch, dk, dv [B, H, N, D]) in the
    operands' dtypes. Scores and statistics are fp32 (fp64 for fp64 inputs);
    ``chunk`` tokens at a time."""
    dz = flare_bwd_dz_ref(q, k, lse, dy, chunk=chunk)
    return flare_bwd_grads_ref(q, k, v, z, mx, den, lse, y, dy, dz, chunk=chunk)


def flare_causal_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           tile: int = 64) -> torch.Tensor:
    """Causal FLARE (the math of ``_causal_chunk_kernel``): q [H, M, D],
    k/v [B, H, T, D] (any strides, T any length) -> y [B, H, T, D] in v's
    dtype. The factored chunk of ``stream_chunk_factored`` over ``tile``
    tokens at a time (the last tile ragged), carrying the latent state.
    Scores and state fp32, fp64 for fp64 inputs; a [B, H, M, tile] and a
    [B, H, tile, tile] temporary at a time."""
    from repro_torch.core.flare_stream import stream_chunk_factored, stream_init

    b, h, t, d = k.shape
    wide = torch.promote_types(v.dtype, torch.float32)
    state = stream_init(b, h, q.shape[1], d, device=k.device, dtype=wide)
    ys = []
    for t0 in range(0, t, tile):
        state, y = stream_chunk_factored(state, q, k[:, :, t0:t0 + tile], v[:, :, t0:t0 + tile])
        ys.append(y)
    return torch.cat(ys, dim=2)


def flare_causal_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           tile: int = 64, parts: int = 2, split: str = "bf16") -> torch.Tensor:
    """Causal FLARE with the products of one of the causal kernel's routes
    emulated (``csrc/flare_causal.cu``). ``split="bf16"``, the bf16 route
    (``causal_tc_kernel``, tile 64): q, k, v hold bf16 values and enter
    exactly; f1, f2, the intra-tile mixing a and the carried numerator enter
    each product as bf16 parts. ``split="tf32"``, the fp32 route
    (``causal_tf32_kernel``, tile 32): every operand, q, k and v too, enters
    as TF32 parts. ``parts=2``: hi + lo, the kernels' choice, a product of
    two split operands drops lo.lo; ``parts=1``: hi alone, one rounding.
    The products are exact (fp64), the weights and sums fp32. q [H, M, D],
    k/v [B, H, T, D] -> y [B, H, T, D] fp32. Over all M at once: the
    kernel's 64-latent slices and their merge change only the order of fp32
    sums."""
    cut = bf16_split if split == "bf16" else tf32_split
    exact = split == "bf16"   # q, k and v are bf16 values: exact in a bf16 MMA

    def part(x):
        hi, lo = cut(x)
        return hi.double(), (lo if parts == 2 else torch.zeros_like(lo)).double()

    def mm(eq, a, b, *, a_exact=False, b_exact=False):
        (ah, al), (bh, bl) = ((x.double(), None) if ex else part(x)
                              for x, ex in ((a, a_exact), (b, b_exact)))
        pairs = ([] if a_exact else [(al, bh)]) + ([] if b_exact else [(ah, bl)]) + [(ah, bh)]
        return sum(torch.einsum(eq, x, y) for x, y in pairs).float()

    b, h, t, d = k.shape
    m = q.shape[1]
    mx = torch.full((b, h, m), -torch.inf, device=k.device)
    den = torch.zeros((b, h, m), device=k.device)
    num = torch.zeros((b, h, m, d), device=k.device)
    ys = []
    for t0 in range(0, t, tile):
        kt, vt = k[:, :, t0:t0 + tile], v[:, :, t0:t0 + tile].float()
        s = mm("hmd,bhtd->bhmt", q, kt, a_exact=exact, b_exact=exact)
        ref = torch.maximum(mx, s.amax(dim=-1))
        scale = torch.exp(mx - ref)
        f1 = torch.exp(s - ref[..., None])
        cden = den[..., None] * scale[..., None] + f1.cumsum(dim=-1)
        w = torch.exp(s - s.amax(dim=-2, keepdim=True))      # decode weights, over M
        f2 = w / cden.clamp_min(1e-30)
        carry = num * scale[..., None]
        y = mm("bhmt,bhmd->bhtd", f2, carry)
        a = mm("bhmt,bhmu->bhtu", f2, f1).tril_()
        y = y + mm("bhtu,bhud->bhtd", a, vt, b_exact=exact)
        num = carry + mm("bhmt,bhtd->bhmd", f1, vt, b_exact=exact)
        den, mx = cden[..., -1], ref
        ys.append(y / w.sum(dim=-2)[..., None])
    return torch.cat(ys, dim=2)


def flash_attention_bf16_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                   scale: float, causal: bool = True, window=None,
                                   parts: int = 2) -> torch.Tensor:
    """The bf16 flash routes with their products emulated (``csrc/
    flash_attention.cu::flash_bf16_kernel``, and ``flash_attention_sm90.cu::
    flash_tc_kernel`` alike): q, k and v bf16 values (exact in a bf16 MMA),
    S = q k^T exact, then fp32 scale, masks, max, weights and den (clamped
    at 1e-30, so a row with no key gives 0); the weights enter P V as bf16
    parts (``parts=2``: hi + lo, the kernels' choice; ``parts=1``: hi alone,
    the TPU kernel's one rounding), the product exact. Over a whole row at
    once: the kernels' key tiles and online rescaling change only the order
    of fp32 sums. q [..., H, Sq, D], k/v [..., Hkv, Skv, D] (Hkv | H) ->
    o [..., H, Sq, D] fp32, before its rounding to bf16."""
    if q.dim() >= 3 and k.shape[-3] != q.shape[-3]:
        groups = q.shape[-3] // k.shape[-3]
        k, v = (t.repeat_interleave(groups, dim=-3) for t in (k, v))
    sq, skv = q.shape[-2], k.shape[-2]
    s = torch.einsum("...sd,...td->...st", q.double(), k.double()).float() * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    s = s.masked_fill(~keep, -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - torch.where(torch.isfinite(mx), mx, 0)), 0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    hi, lo = bf16_split(p)
    pw = hi.double() + (lo.double() if parts == 2 else 0)
    return torch.einsum("...st,...td->...sd", pw, v.double()).float() / den


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                        causal: bool = True, window=None, q_offset: int = 0) -> torch.Tensor:
    """Masked softmax attention (the math of ``_flash_kernel``): q [..., H, Sq, D],
    k/v [..., Hkv, Skv, D] with Hkv | H (GQA: query head h reads KV head
    h // (H / Hkv); k and v are expanded here, as the kernel reads them
    unexpanded) -> o [..., H, Sq, D] in v's dtype. Scores q k^T in fp32
    (fp64 for fp64 inputs) times ``scale``; ``causal`` keeps key j <= query i
    (top-left aligned when Sq != Skv), ``window`` keeps j > i - window; masked
    scores are -inf, the softmax's NaN rows (no key left) become 0, and the
    weights are cast to v's dtype before the value product. ``q_offset`` is
    the index of q's first row, so that a block of queries can be run alone
    (the kernel takes no offset)."""
    if q.dim() >= 3 and k.shape[-3] != q.shape[-3]:
        groups = q.shape[-3] // k.shape[-3]
        k, v = (t.repeat_interleave(groups, dim=-3) for t in (k, v))
    sq, skv = q.shape[-2], k.shape[-2]
    # flarecheck: disable=DS003 -- f32-staged by _wide; the rule sees only astype casts
    s = torch.einsum("...sd,...td->...st", _wide(q), _wide(k)) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    w = torch.softmax(s.masked_fill(~ok, -torch.inf), dim=-1)
    del s
    w = torch.nan_to_num(w, nan=0.0)                            # fully masked rows -> 0
    return torch.einsum("...st,...td->...sd", w.to(v.dtype), v)


def _gather_rows(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[NB, block, H, ...] pages + [B, P] page table -> [B, H, P*block, ...]
    (one-byte payloads are gathered through a uint8 view, which every
    torch version indexes)."""
    one_byte = pages.element_size() == 1 and pages.dtype not in (torch.int8, torch.uint8)
    src = pages.view(torch.uint8) if one_byte else pages
    x = src[page_table.long()]                                   # [B, P, block, H, ...]
    if one_byte:
        x = x.view(pages.dtype)
    b, p, blk = x.shape[:3]
    return x.reshape(b, p * blk, *x.shape[3:]).movedim(2, 1)


def paged_out_dtype(q: torch.Tensor, v_pages: torch.Tensor, out_dtype=None) -> torch.dtype:
    """The output dtype of a paged-attention call: ``out_dtype``, else the
    pages' dtype where that is fp32 or bf16, else q's."""
    if out_dtype is not None:
        return out_dtype
    return v_pages.dtype if v_pages.dtype in (torch.float32, torch.bfloat16) else q.dtype


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *, scale: float = 1.0,
                        k_scale=None, v_scale=None, q2=None, k2_pages=None, k2_scale=None,
                        out_dtype=None) -> torch.Tensor:
    """Softmax over each lane's valid tokens (t < lengths[b]) of its pages
    ``page_table[b, :]``, applied to v: q [B, H, G, D], pages [NB, block, H, D]
    -> o [B, H, G, D]. Scores s = (q k^T) * k_scale [+ (q2 k2^T) * k2_scale],
    then ``* scale``, then the mask, an fp32 softmax (fp64 for fp64 q), the
    weights times v_scale, and the value product. Without scales or q2, and
    with q's dtype equal to the pages', the weights are cast to v's dtype
    before the value product, as the kernel does. Rows past a lane's length
    are zeroed before use, so garbage there (even non-finite) is invisible;
    a lane of length 0 returns 0."""
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    fused = (k_scale is not None or v_scale is not None or q2 is not None
             or q.dtype != k_pages.dtype)
    k = _gather_rows(k_pages, page_table).to(wide)                # [B, H, T, D]
    v = _gather_rows(v_pages, page_table).to(wide)
    t = k.shape[2]
    valid = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device).long()[:, None]
    valid = valid[:, None, :]                                     # [B, 1, T]
    k = k.masked_fill(~valid[..., None], 0)
    v = v.masked_fill(~valid[..., None], 0)
    s = torch.einsum("bhgd,bhtd->bhgt", q.to(wide), k)
    if k_scale is not None:
        s = s * _gather_rows(k_scale, page_table).to(wide)[:, :, None, :]
    if q2 is not None:
        k2 = _gather_rows(k2_pages, page_table).to(wide).masked_fill(~valid[..., None], 0)
        s2 = torch.einsum("bhgd,bhtd->bhgt", q2.to(wide), k2)
        if k2_scale is not None:
            s2 = s2 * _gather_rows(k2_scale, page_table).to(wide)[:, :, None, :]
        s = s + s2
    s = (s * scale).masked_fill(~valid[:, :, None, :], -torch.inf)
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)      # all-masked lanes -> 0
    if v_scale is not None:
        w = w * _gather_rows(v_scale, page_table).to(wide)[:, :, None, :]
    if not fused:
        w = w.to(v_pages.dtype).to(wide)
    o = torch.einsum("bhgt,bhtd->bhgd", w, v)
    return o.to(paged_out_dtype(q, v_pages, out_dtype))
