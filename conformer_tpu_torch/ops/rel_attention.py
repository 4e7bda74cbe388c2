"""Relative-position flash attention with in-kernel dropout, forward and
backward: CUDA kernels, their plain versions and the autograd Function.

Replaces the Pallas TPU kernels of ``conformer_tpu/ops/pallas/
attention_kernel.py``: the forward (``_attn_fwd_kernel``, ``_fwd_impl``),
the dropout keep-mask hash (``_tile_keep_mask``) and the backward
(``_flash_bwd``: ``_attn_bwd_dq_kernel``, ``_attn_bwd_dkv_kernel``). The
kernels are ``csrc/rel_flash_attention.cu`` (forward) and
``csrc/rel_flash_attention_bwd.cu`` (dq and dkv; ``rel_attention_bwd``
runs both, in bf16 from one dS), each with two routes by width
(``route``); their source notes give the bounds and the designs. Each
wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors (the tests' path); each counts its launches in
``<wrapper>.launches``.

``rel_flash_attention`` is the differentiable entry point (the JAX
``rel_flash_attention`` with its custom VJP): the forward saves the per-row
log-sum-exp, and the backward recomputes the score tiles from it.

Dropout on the attention probabilities: the keep-mask is a counter hash of
(seed, b*H + h, global query row, global key column), ``tile_keep_mask``,
bit for bit the JAX ``_tile_keep_mask``; the seed is a one-element int32
tensor that the kernels read on the device. Under tensor parallelism a
rank holds heads [h_offset, h_offset + H) of ``h_total``: every function
here takes (``h_total``, ``h_offset``), default (H, 0), and hashes head h
of batch row b as b*h_total + h_offset + h, so that a rank's heads draw
the mask the whole attention draws for them. The normaliser comes from the
un-dropped probabilities; only the PV sum sees p * keep / (1 - rate).
"""

from __future__ import annotations

import torch

from . import cuda_build

NEG_INF = -1e30
LSE_BIG = 1e30      # lse of a fully masked row
_M32 = 0xFFFFFFFF
MAX_DK = 128        # head width of the wide kernels' register tiles
NARROW_DK = 64      # head width of the narrow kernels' register tiles
NARROW_KD = 576     # the narrow bf16 kernels' score depth round64(round16(dk) + D)
NARROW_D_F32 = 512  # the narrow float32 dq kernel keeps 32 dAB columns a thread
DS_KEYS = 128       # the wide bf16 backward's key tile: its scratch rows are padded to a multiple


# ------------------------------------------------------------ keep-mask hash


def keep_threshold(rate: float) -> int:
    """uint32(rate * 2^32), as the JAX kernel's ``np.uint32`` of it."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    return int(rate * 4294967296.0)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): the constant is split
    in 16-bit halves so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def tile_keep_mask(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """Keep-mask of the probabilities at (``bh`` = b*H + h, ``rows``,
    ``cols``), int64 tensors that broadcast together, for the int32
    ``seed`` (a tensor or an int): the uint32 hash of the JAX
    ``_tile_keep_mask`` in int64 arithmetic masked to 32 bits. True where
    the probability is kept (share 1 - rate)."""
    seed = torch.as_tensor(seed, device=rows.device).long() & _M32
    x = (_mul32(seed, 0x9E3779B9) + _mul32(bh & _M32, 0x85EBCA6B)) & _M32
    x = x ^ _mul32(rows & _M32, 0xC2B2AE35)
    x = x ^ _mul32(cols & _M32, 0x27D4EB2F)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def keep_mask(seed, b: int, h: int, tq: int, tk: int, rate: float, device,
              h_total: int | None = None, h_offset: int = 0) -> torch.Tensor:
    """bool [B, H, Tq, Tk] keep-mask of ``seed`` at heads [h_offset,
    h_offset + H) of an attention of ``h_total`` heads (default H: the
    whole attention)."""
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int64)  # noqa: E731
    h_total = h if h_total is None else h_total
    bh = (ar(b)[:, None] * h_total + h_offset + ar(h)[None, :])[:, :, None, None]
    return tile_keep_mask(seed, bh, ar(tq)[:, None], ar(tk)[None, :], rate)


def _inv_keep(rate: float) -> torch.Tensor:
    """1 / (1 - rate) as float32, the factor the kernels multiply by."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)


# ------------------------------------------------------------ plain versions


def _probs(q_u, ab, k, k_feats, mask, scale, lse=None):
    """Scaled scores [B,H,Tq,Tk] in float32 (masked entries -1e30) or, given
    ``lse``, the probabilities exp(s - lse) where the mask allows, else 0."""
    s = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    s = s + torch.matmul(ab.float(), k_feats.float().transpose(-1, -2))
    m4 = mask[:, None, :, :]
    if lse is None:
        return torch.where(m4, s * scale, torch.full_like(s, NEG_INF))
    return torch.where(m4, torch.exp(s * scale - lse[..., None]), torch.zeros_like(s))


def rel_attention_plain(q_u, ab, k, v, k_feats, mask, *, scale: float,
                        dropout_rate: float = 0.0, seed=None, h_total: int | None = None,
                        h_offset: int = 0):
    """dropout(softmax(((q+u)K^T + AB F^T) * scale, mask)) V in float32.

    q_u, k, v [B,H,Tq|Tk,dk]; ab [B,H,Tq,D]; k_feats [Tk,D]; mask bool
    [B,Tq,Tk] (True = attend); ``seed`` int32 [1] when ``dropout_rate`` >
    0; (``h_total``, ``h_offset``): the heads' place in the whole
    attention, for the keep-mask. Returns (out [B,H,Tq,dk] in v's dtype,
    lse float32 [B,H,Tq] of the un-dropped probabilities); a fully masked
    row gives out 0 and lse 1e30.
    """
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    s = _probs(q_u, ab, k, k_feats, mask, scale)
    m4 = mask[:, None, :, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        b, h, tq, tk = p.shape
        keep = keep_mask(seed, b, h, tq, tk, dropout_rate, p.device, h_total, h_offset)
        p = torch.where(keep, p * _inv_keep(dropout_rate).to(p.device), torch.zeros_like(p))
    out = torch.matmul(p, v.float()) / l.clamp_min(1e-30)
    live = l > 0.0
    out = torch.where(live, out, torch.zeros_like(out))
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, LSE_BIG))
    return out.to(v.dtype), lse[..., 0]


def rel_attention_bwd_plain(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta, *,
                            scale: float, dropout_rate: float = 0.0,
                            h_total: int | None = None, h_offset: int = 0):
    """The backward of ``rel_attention_plain`` written out, as the two
    kernels compute it from the saved ``lse`` and ``delta`` = rowsum(dO *
    O) [B,H,Tq] float32: returns float32 (dQu, dAB, dK, dV)."""
    p = _probs(q_u, ab, k, k_feats, mask, scale, lse.float())
    g = dout.float()
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        b, h, tq, tk = p.shape
        keep = keep_mask(seed, b, h, tq, tk, dropout_rate, p.device, h_total, h_offset)
        inv = _inv_keep(dropout_rate).to(p.device)
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
        pd = torch.where(keep, p * inv, torch.zeros_like(p))
    ds = p * (dp - delta.float()[..., None]) * scale
    d_q = torch.matmul(ds, k.float())
    d_ab = torch.matmul(ds, k_feats.float())
    d_k = torch.matmul(ds.transpose(-1, -2), q_u.float())
    d_v = torch.matmul(pd.transpose(-1, -2), g)
    return d_q, d_ab, d_k, d_v


# ------------------------------------------------------------ kernel wrappers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fwd_bf16_smem(dk: int, d: int) -> int:
    """Shared memory, in bytes, of one block of the mma.sync bf16 forward at
    head width ``dk`` and bias width ``d``, at 4 warps, its smallest block
    (``fwd_bf16_smem`` of ``csrc/rel_attention_common.cuh``): rows of
    [q+u | AB] and [K | F] kd = round64(round16(dk) + d) wide, plus 8."""
    ldv = _round_up(dk, 16) + 8
    lda = _round_up(_round_up(dk, 16) + d, 64) + 8
    return 2 * (64 * lda + 2 * 32 * (lda + ldv))


def route(dtype, dk: int, d: int) -> str:
    """Which path of the kernels runs head width ``dk`` and bias width
    ``d`` in ``dtype`` (``wide_width``, ``narrow_width`` of
    ``csrc/rel_attention_common.cuh``). In bf16 "wide", the kernels on
    wgmma fed by TMA, wherever dk <= 128 and dk and D are multiples of 8
    (Conformer-M, -L and the 1024-wide Conformer); "narrow", the mma.sync
    forward, for the others with dk <= 64 whose score depth round64(
    round16(dk) + D) <= 576 fits its block in shared memory (Conformer-S's
    dk 36); their backward runs the wide kernels on operands zero-padded to
    multiples of 8 (``tma_width``). In float32 "narrow" for dk <= 64 and D
    <= 512, else "wide" (D streamed in chunks)."""
    if dk > NARROW_DK:
        return "wide"
    if dtype == torch.bfloat16:
        narrow = bool(dk % 8 or d % 8) and _round_up(_round_up(dk, 16) + d, 64) <= NARROW_KD \
            and fwd_bf16_smem(dk, d) <= cuda_build.SMEM_LIMIT
    else:
        narrow = d <= NARROW_D_F32
    return "narrow" if narrow else "wide"


def width_error(dtype, dk: int, d: int) -> str | None:
    """Why the kernels refuse head width ``dk`` and bias width ``d`` in
    ``dtype``, or None where they take them: dk <= 128 and any D; the bf16
    wide path (``route``) reads rows by TMA, whose row strides are
    multiples of 16 bytes, so there dk and D are multiples of 8."""
    if dk > MAX_DK:
        return f"dk={dk} > {MAX_DK}"
    if (dtype == torch.bfloat16 and route(dtype, dk, d) == "wide"
            and (dk % 8 or d % 8)):
        return f"dk={dk}, D={d}: the bf16 wide kernels take dk and D multiples of 8"
    return None


def tma_width(n: int) -> int:
    """Width ``n`` rounded up to a multiple of 8: the bf16 backward runs the
    wide kernels, whose TMA rows need 16-byte strides, on q+u, K, V, dO
    (dk) and AB, F (D) zero-padded to it, which adds nothing to any score
    or gradient, and cuts its outputs back."""
    return _round_up(n, 8)


def _pad_to(x, n: int):
    """``x`` zero-padded in its last dimension to ``n`` (itself at ``n``)."""
    return x if x.shape[-1] == n else torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def scratch_shape(b: int, h: int, tq: int, tk: int, pd: bool) -> tuple[int, ...]:
    """Shape of the wide bf16 backward's scratch (``csrc/rel_flash_attention_bwd.cu``):
    dS, and with ``pd`` the dropped probabilities after it, each bf16 [B,
    H, Tq, round128(Tk)] (dq's kernels read dS alone, dkv's both)."""
    return (2 if pd else 1, b, h, tq, _round_up(tk, DS_KEYS))


def _aligned(*tensors):
    """The tensors, each copied to a fresh (16-byte aligned) block where its
    data does not start on 16 bytes: the bf16 wide kernels' TMA boxes need
    16-byte aligned addresses."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _check(name, q_u, ab, k, v, k_feats, mask, seed, dropout_rate, dout=None, lse=None,
           delta=None):
    tensors = [t for t in (q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta)
               if t is not None]
    if q_u.device.type != "cuda" or any(t.device != q_u.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    dtype = q_u.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dtype for t in (ab, k, v, k_feats, dout) if t is not None
    ):
        raise TypeError(f"{name}: inputs must all be float32 or all bfloat16")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool")
    if any(t is not None and t.dtype != torch.float32 for t in (lse, delta)):
        raise TypeError(f"{name}: lse and delta must be float32")
    if dropout_rate > 0.0 and (seed is None or seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError(f"{name}: dropout needs an int32 seed tensor of one element")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    b, h, tq, dk = q_u.shape
    tk, d = k_feats.shape
    if (
        ab.shape != (b, h, tq, d)
        or k.shape != (b, h, tk, dk)
        or v.shape != (b, h, tk, dk)
        or mask.shape != (b, tq, tk)
        or any(t is not None and t.shape != q_u.shape for t in (dout,))
        or any(t is not None and t.shape != (b, h, tq) for t in (lse, delta))
    ):
        raise ValueError(f"{name}: inconsistent shapes")
    if min(b, h, tq, tk, dk, d) == 0:
        raise ValueError(f"{name}: empty shape {tuple(q_u.shape)}, D={d}")
    why = width_error(dtype, dk, d)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    return b, h, tq, tk, dk, d


def _drop_args(dropout_rate: float):
    """(drop flag, keep threshold as an int32 bit pattern, 1/(1-rate))."""
    thr = keep_threshold(dropout_rate)
    thr_bits = thr - (1 << 32) if thr >= 1 << 31 else thr
    return int(dropout_rate > 0.0), thr_bits, float(_inv_keep(dropout_rate))


def _heads(h: int, h_total: int | None, h_offset: int) -> tuple[int, int]:
    """(h_total, h_offset) of the keep-mask hash, checked: heads [h_offset,
    h_offset + h) must lie within h_total."""
    h_total = h if h_total is None else h_total
    if h_offset < 0 or h_offset + h > h_total:
        raise ValueError(f"heads [{h_offset}, {h_offset + h}) do not lie in h_total={h_total}")
    return h_total, h_offset


def _seed_ptr(seed, dropout_rate):
    return cuda_build.ptr(seed) if dropout_rate > 0.0 else None


def rel_attention(q_u, ab, k, v, k_feats, mask, *, scale: float, dropout_rate: float = 0.0,
                  seed=None, h_total: int | None = None, h_offset: int = 0):
    """Forward kernel wrapper with the contract of ``rel_attention_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: float32 or bfloat16 inputs of one dtype, contiguous, widths that
    ``width_error`` passes (``route`` says which kernels);
    ``seed`` an int32 CUDA tensor of one element when ``dropout_rate`` > 0.
    """
    keep_threshold(dropout_rate)
    h_total, h_offset = _heads(q_u.shape[1], h_total, h_offset)
    if q_u.device.type == "cpu":
        return rel_attention_plain(q_u, ab, k, v, k_feats, mask, scale=scale,
                                   dropout_rate=dropout_rate, seed=seed, h_total=h_total,
                                   h_offset=h_offset)
    b, h, tq, tk, dk, d = _check("rel_attention", q_u, ab, k, v, k_feats, mask, seed,
                                 dropout_rate)
    if q_u.dtype == torch.bfloat16 and route(q_u.dtype, dk, d) == "wide":
        q_u, ab, k, v, k_feats = _aligned(q_u, ab, k, v, k_feats)
    fn = cuda_build.load_function("rel_flash_attention", "rel_flash_attention_fwd",
                                  n_ptrs=10, n_ints=11, n_floats=2)
    out = torch.empty((b, h, tq, dk), dtype=q_u.dtype, device=q_u.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q_u.device)
    drop, thr_bits, inv_keep = _drop_args(dropout_rate)
    P = cuda_build.ptr
    err = fn(
        P(q_u), P(ab), P(k), P(v), P(k_feats), P(mask), _seed_ptr(seed, dropout_rate),
        P(out), P(lse), cuda_build.stream_ptr(q_u), b, h, tq, tk, dk, d,
        int(q_u.dtype == torch.bfloat16), drop, thr_bits, h_total, h_offset, float(scale),
        inv_keep,
    )
    cuda_build.check(err, "rel_flash_attention")
    rel_attention.launches += 1
    return out, lse


def _bwd_kernel(symbol, q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta, scale,
                dropout_rate, h_total, h_offset, outs):
    """Launch ``symbol`` and return its float32 outputs ``outs`` (names of
    "dq", "dab", "dk", "dv"). bf16 runs the wide kernels: dk and D padded to
    ``tma_width`` where they are not multiples of 8, the outputs cut back,
    and the scratch of dS (and of pd, but for dq alone) made once."""
    b, h, tq, tk, dk, d = _check(symbol, q_u, ab, k, v, k_feats, mask, seed, dropout_rate,
                                 dout, lse, delta)
    scratch, pk, pd = None, dk, d
    if q_u.dtype == torch.bfloat16:
        pk, pd = tma_width(dk), tma_width(d)
        q_u, k, v, dout = (_pad_to(x, pk) for x in (q_u, k, v, dout))
        ab, k_feats = _pad_to(ab, pd), _pad_to(k_feats, pd)
        q_u, ab, k, v, k_feats, dout = _aligned(q_u, ab, k, v, k_feats, dout)
        scratch = torch.empty(scratch_shape(b, h, tq, tk, symbol != "rel_flash_attention_bwd_dq"),
                              dtype=torch.bfloat16, device=q_u.device)
    shapes = {"dq": (b, h, tq, pk), "dab": (b, h, tq, pd), "dk": (b, h, tk, pk),
              "dv": (b, h, tk, pk)}
    bufs = [torch.empty(shapes[o], dtype=torch.float32, device=q_u.device) for o in outs]
    fn = cuda_build.load_function("rel_flash_attention_bwd", symbol,
                                  n_ptrs=12 + len(bufs), n_ints=11, n_floats=2)
    drop, thr_bits, inv_keep = _drop_args(dropout_rate)
    P = cuda_build.ptr
    err = fn(
        P(q_u), P(ab), P(k), P(v), P(k_feats), P(mask), _seed_ptr(seed, dropout_rate),
        P(dout), P(lse), P(delta), *(P(o) for o in bufs),
        None if scratch is None else P(scratch), cuda_build.stream_ptr(q_u),
        b, h, tq, tk, pk, pd, int(q_u.dtype == torch.bfloat16), drop, thr_bits, h_total,
        h_offset, float(scale), inv_keep,
    )
    cuda_build.check(err, symbol)
    width = {"dq": dk, "dab": d, "dk": dk, "dv": dk}
    return tuple(x[..., :width[o]] if x.shape[-1] != width[o] else x for x, o in zip(bufs, outs))


def rel_attention_bwd_dq(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta, *,
                         scale: float, dropout_rate: float = 0.0,
                         h_total: int | None = None, h_offset: int = 0):
    """(dQu [B,H,Tq,dk], dAB [B,H,Tq,D]) in float32: the dq kernel for CUDA
    tensors (widths as ``rel_attention``), the plain backward's for CPU
    tensors."""
    h_total, h_offset = _heads(q_u.shape[1], h_total, h_offset)
    if q_u.device.type == "cpu":
        return rel_attention_bwd_plain(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta,
                                       scale=scale, dropout_rate=dropout_rate,
                                       h_total=h_total, h_offset=h_offset)[:2]
    outs = _bwd_kernel("rel_flash_attention_bwd_dq", q_u, ab, k, v, k_feats, mask, seed,
                       dout, lse, delta, scale, dropout_rate, h_total, h_offset, ["dq", "dab"])
    rel_attention_bwd_dq.launches += 1
    return outs


def rel_attention_bwd_dkv(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta, *,
                          scale: float, dropout_rate: float = 0.0,
                          h_total: int | None = None, h_offset: int = 0):
    """(dK, dV [B,H,Tk,dk]) in float32: the dkv kernel for CUDA tensors,
    the plain backward's for CPU tensors."""
    h_total, h_offset = _heads(q_u.shape[1], h_total, h_offset)
    if q_u.device.type == "cpu":
        return rel_attention_bwd_plain(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta,
                                       scale=scale, dropout_rate=dropout_rate,
                                       h_total=h_total, h_offset=h_offset)[2:]
    outs = _bwd_kernel("rel_flash_attention_bwd_dkv", q_u, ab, k, v, k_feats, mask, seed,
                       dout, lse, delta, scale, dropout_rate, h_total, h_offset, ["dk", "dv"])
    rel_attention_bwd_dkv.launches += 1
    return outs


def rel_attention_bwd(q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta, *,
                      scale: float, dropout_rate: float = 0.0,
                      h_total: int | None = None, h_offset: int = 0):
    """(dQu, dAB, dK, dV) in float32: ``rel_attention_bwd_dq`` and
    ``rel_attention_bwd_dkv`` together, for CUDA tensors in one call in
    bf16 (dS and pd made once for both, then both products: each of the
    two counts one launch), one by one in float32; the plain backward for
    CPU tensors."""
    h_total, h_offset = _heads(q_u.shape[1], h_total, h_offset)
    args = (q_u, ab, k, v, k_feats, mask, seed, dout, lse, delta)
    kw = dict(scale=scale, dropout_rate=dropout_rate, h_total=h_total, h_offset=h_offset)
    if q_u.device.type == "cpu":
        return rel_attention_bwd_plain(*args, **kw)
    if q_u.dtype != torch.bfloat16:
        return (*rel_attention_bwd_dq(*args, **kw), *rel_attention_bwd_dkv(*args, **kw))
    outs = _bwd_kernel("rel_flash_attention_bwd", *args, scale, dropout_rate, h_total, h_offset,
                       ["dq", "dab", "dk", "dv"])
    rel_attention_bwd_dq.launches += 1
    rel_attention_bwd_dkv.launches += 1
    return outs


rel_attention.launches = 0
rel_attention_bwd_dq.launches = 0
rel_attention_bwd_dkv.launches = 0


# ------------------------------------------------------------ autograd


class _RelFlash(torch.autograd.Function):
    """The JAX ``_flash`` custom VJP: the forward saves (inputs, seed, out,
    lse); the backward computes delta = rowsum(dO * O) as a torch op and
    runs the dq and dkv kernels (``rel_attention_bwd``). ``k_feats``,
    ``mask`` and ``seed`` carry no gradient (sinusoids of positions, a
    mask, a seed)."""

    @staticmethod
    def forward(ctx, q_u, ab, k, v, k_feats, mask, seed, scale, dropout_rate, h_total,
                h_offset):
        out, lse = rel_attention(q_u, ab, k, v, k_feats, mask, scale=scale,
                                 dropout_rate=dropout_rate, seed=seed, h_total=h_total,
                                 h_offset=h_offset)
        ctx.save_for_backward(q_u, ab, k, v, k_feats, mask, seed, out, lse)
        ctx.scale, ctx.dropout_rate, ctx.heads = scale, dropout_rate, (h_total, h_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q_u, ab, k, v, k_feats, mask, seed, out, lse = ctx.saved_tensors
        g = g.to(q_u.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        args = (q_u, ab, k, v, k_feats, mask, seed, g, lse, delta)
        kw = dict(scale=ctx.scale, dropout_rate=ctx.dropout_rate, h_total=ctx.heads[0],
                  h_offset=ctx.heads[1])
        d_q, d_ab, d_k, d_v = rel_attention_bwd(*args, **kw)
        return (d_q.to(q_u.dtype), d_ab.to(ab.dtype), d_k.to(k.dtype), d_v.to(v.dtype),
                None, None, None, None, None, None, None)


def rel_flash_attention(q_u, ab, k, v, k_feats, mask, *, scale: float,
                        dropout_rate: float = 0.0, seed=None, h_total: int | None = None,
                        h_offset: int = 0) -> torch.Tensor:
    """Differentiable attention output [B,H,Tq,dk] in v's dtype (the JAX
    ``rel_flash_attention``); ``seed`` int32 [1] on the inputs' device is
    required when ``dropout_rate`` > 0; (``h_total``, ``h_offset``): the
    heads' place in the whole attention, for the keep-mask (default: the
    whole attention)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    h_total, h_offset = _heads(q_u.shape[1], h_total, h_offset)
    return _RelFlash.apply(q_u, ab, k, v, k_feats, mask, seed, scale, dropout_rate, h_total,
                           h_offset)
