"""Fused transducer joint over the full lattice: CUDA kernels, forward and
backward, and their plain versions.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/joint_kernel.py``
(``_forward`` / ``_fwd_kernel``; ``_backward``'s ``_bwd_xp_kernel`` and
``_bwd_w_kernel``; wrapped by ``joint_lattice_log_probs_pallas``). The
kernels are ``csrc/joint_lattice.cu``; its source note gives the math, the
bound and the design. ``joint_lattice_fwd``, ``joint_lattice_bwd_xp`` and
``joint_lattice_bwd_w`` launch them for CUDA tensors and take the plain
versions only for CPU tensors; each counts in ``.launches`` the grids it
launched (1, 2 and 3 per call on the narrow kernels: the backwards sum
across blocks in extra grids, in a fixed order; on the wide route the
forward 2 per chunk of cells and 2, each backward 3 per chunk and 2). The
plain versions are chunked over T, so they build [B, t_chunk, U+1, V] at
a time and never the whole lattice. The kernels take J in multiples of
128: the wrappers zero-pad J (``pad_join``, exact) and slice the gradients
back. Every J is taken (``width_error``); ``route`` says which kernels run
it, by dtype and direction: the narrow ones for bf16 enc at the shipped
widths (the forward up to 640, the backward up to 512, after padding),
the wide route for float32 at every J and for bf16 above (per chunk of
cells the products on wgmma fed by TMA, 3xTF32 in float32: the forward's
logits product with a logsumexp epilogue, ``joint_lattice_fwd_wide`` in
the C source; the backward's two products, ``joint_lattice_bwd_xp_wide``
and ``_bwd_w_wide``).

Inputs everywhere: enc [B, T, J] and pred [B, U+1, J], each float32 or
bfloat16 (the model gives bf16 enc and float32 pred: the predictor runs in
float32), W [J, V] and bias [V] of any float dtype, lab [B, U+1] (the
padded labels: label u+1 at row u, blank at row U). As in the TPU kernel,
x = tanh(enc + pred) takes the sum in the wider dtype (rounded to bf16
when both are bf16) and is rounded to enc's dtype, W is cast to enc's
dtype, and the logits' sums, the logsumexp and every result are float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

_V_TILE = 64            # the backward's V tile: W and the bias are padded to a multiple of it
_FWD_V_TILE = 128       # the forward's
J_TILE = 128            # the kernels take J in multiples of it: the wrappers pad J with zeros
DTYPES = (torch.float32, torch.bfloat16)   # enc's dtypes that the kernels take
# the narrow kernels' padded J, by direction, bf16 enc only (csrc/joint_lattice.cu
# NARROW_FWD_J_BF16, NARROW_BWD_J_BF16); float32 takes the wide route at every J
NARROW_J = {"fwd": {torch.bfloat16: 640}, "bwd": {torch.bfloat16: 512}}
_BWD_W_BLOCKS = 4 * 132   # bwd_w's grid: at least four blocks per SM of an H100
_BWD_W_ROWS = 8192        # bwd_w: cells summed in float32 into one partial dW, at most
_MAX_CHUNKS = 128
_WIDE_TILE = 128          # the wide route's tiles: 128 cells (or J rows) a block
_WIDE_DL_BYTES = 1 << 29  # the wide route: dl of one chunk of cells, at most (512 MiB)


def _picks_index(lab, v: int):
    """(index, valid) of each row's label; a label outside [0, V) picks nothing."""
    ok = (lab >= 0) & (lab < v)
    return torch.where(ok, lab, 0).long(), ok


def _chunk(enc, pred, wf, bf, sl):
    """(x, logits) of the t rows ``sl``: x = tanh(enc + pred) rounded to
    enc's dtype, widened; logits float32."""
    x = torch.tanh(enc[:, sl, None, :] + pred[:, None, :, :]).to(enc.dtype).float()
    return x, torch.matmul(x, wf) + bf


def joint_lattice_plain_fwd(enc, pred, w, b, lab, blank: int, t_chunk: int = 16):
    """-> (lp_blank, lp_emit, logZ) [B, T, U+1] float32."""
    bsz, t, _ = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    wf, bf = w.to(enc.dtype).float(), b.float()
    idx, ok = _picks_index(lab, v)
    lpb, lpe, lzs = [], [], []
    for t0 in range(0, t, t_chunk):
        _, logits = _chunk(enc, pred, wf, bf, slice(t0, t0 + t_chunk))
        logz = torch.logsumexp(logits, dim=-1)
        tc = logits.shape[1]
        em = logits.gather(3, idx[:, None, :, None].expand(bsz, tc, u1, 1))[..., 0]
        lpb.append(logits[..., blank] - logz)
        lpe.append(torch.where(ok[:, None, :], em, 0.0) - logz)
        lzs.append(logz)
    return torch.cat(lpb, dim=1), torch.cat(lpe, dim=1), torch.cat(lzs, dim=1)


def _plain_bwd(enc, pred, w, b, lab, logz, g_blank, g_emit, blank: int, t_chunk: int,
               want_xp: bool, want_w: bool):
    """The backward written out (the TPU kernel's K_A and K_B): from the
    saved logZ, dl = -(g_b + g_e) p + g_b [v=blank] + g_e [v=lab]; dpre =
    (dl W^T)(1 - x^2) summed over u (d enc) and t (d pred); dW = x^T dl,
    dbias = sum dl. Everything float32."""
    bsz, t, j = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    wf, bf = w.to(enc.dtype).float(), b.float()
    idx, ok = _picks_index(lab, v)
    d_enc = torch.zeros((bsz, t, j), dtype=torch.float32, device=enc.device)
    d_pred = torch.zeros((bsz, u1, j), dtype=torch.float32, device=enc.device)
    dw = torch.zeros((j, v), dtype=torch.float32, device=enc.device)
    db = torch.zeros((v,), dtype=torch.float32, device=enc.device)
    for t0 in range(0, t, t_chunk):
        sl = slice(t0, t0 + t_chunk)
        x, logits = _chunk(enc, pred, wf, bf, sl)
        gb, ge = g_blank[:, sl].float(), g_emit[:, sl].float()
        tc = gb.shape[1]
        dl = -(gb + ge)[..., None] * torch.exp(logits - logz[:, sl, :, None])
        dl[..., blank] += gb
        dl.scatter_add_(3, idx[:, None, :, None].expand(bsz, tc, u1, 1),
                        torch.where(ok[:, None, :], ge, 0.0)[..., None])
        if want_xp:
            dpre = torch.matmul(dl, wf.T) * (1.0 - x * x)
            d_enc[:, sl] = dpre.sum(dim=2)
            d_pred += dpre.sum(dim=1)
        if want_w:
            dw += x.reshape(-1, j).T @ dl.reshape(-1, v)
            db += dl.sum(dim=(0, 1, 2))
    return d_enc, d_pred, dw, db


def joint_lattice_plain_bwd_xp(enc, pred, w, b, lab, logz, g_blank, g_emit, blank: int,
                               t_chunk: int = 16):
    """-> (d enc [B, T, J], d pred [B, U+1, J]) float32."""
    return _plain_bwd(enc, pred, w, b, lab, logz, g_blank, g_emit, blank, t_chunk, True,
                      False)[:2]


def joint_lattice_plain_bwd_w(enc, pred, w, b, lab, logz, g_blank, g_emit, blank: int,
                              t_chunk: int = 16):
    """-> (dW [J, V], dbias [V]) float32."""
    return _plain_bwd(enc, pred, w, b, lab, logz, g_blank, g_emit, blank, t_chunk, False,
                      True)[2:]


# ------------------------------------------------------------------ kernels


def route(dtype, j: int, direction: str = "fwd") -> str:
    """Which kernels run join width ``j`` with enc in ``dtype`` in
    ``direction`` ("fwd" or "bwd"; J padded to a multiple of ``J_TILE``
    first): "narrow" for bf16 enc (the model's) at every shipped width,
    padded J <= 640 forward (Conformer-S 320 -> 384, M 512, L 640) and
    <= 512 backward, each a fused wgmma kernel that computes its own x
    tile; else "wide": float32 (the parity path) at every J, bf16 above.
    The wide route writes x and W^T once in the layouts the tensor cores
    read and runs its products per chunk of cells on wgmma fed by TMA
    (3xTF32 in float32): the forward's logits product with a logsumexp
    epilogue (per V tile partial max and sum of exps, folded by a last
    grid); the backward's two products, dl between them in device
    memory."""
    jp = -(-j // J_TILE) * J_TILE
    return "narrow" if jp <= NARROW_J[direction].get(dtype, 0) else "wide"


def width_error(dtype, j: int) -> str | None:
    """Why the kernels refuse join width ``j`` with enc in ``dtype``, or
    None where all three take it: enc float32 or bfloat16 and any J >= 1,
    as JAX's kernel, which takes the whole J as one block (``route``)."""
    if dtype not in DTYPES:
        return f"enc must be float32 or bfloat16, got {dtype}"
    if j <= 0:
        return f"J={j}: the join width must be positive"
    return None


def pad_join(enc, pred, w):
    """(enc, pred, W) with J zero-padded to a multiple of ``J_TILE``, each in
    its own dtype (the model passes bf16 enc and float32 pred). Exact: in
    the padded columns x = tanh(0 + 0) = 0 and W's padded rows are 0, so
    the logits do not change, and dpre, d enc, d pred and dW come out 0
    there (the wrappers slice them away)."""
    pad = (-enc.shape[-1]) % J_TILE
    if pad == 0:
        return enc, pred, w
    return F.pad(enc, (0, pad)), F.pad(pred, (0, pad)), F.pad(w, (0, 0, 0, pad))


def _check(name, enc, pred, w, b, lab, blank, lattice=()):
    dev = enc.device
    tensors = (enc, pred, w, b, lab, *lattice)
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if any(x.dtype not in (torch.float32, torch.bfloat16) for x in (enc, pred)):
        raise TypeError(f"{name}: enc and pred must be float32 or bfloat16")
    if lab.dtype != torch.int32 or any(x.dtype != torch.float32 for x in lattice):
        raise TypeError(f"{name}: int32 labels and float32 lattice tensors expected")
    if not all(x.is_contiguous() for x in (enc, pred, lab, *lattice)):
        raise ValueError(f"{name}: inputs must be contiguous")
    bsz, t, j = enc.shape
    u1, v = pred.shape[1], w.shape[1]
    if pred.shape != (bsz, u1, j) or w.shape != (j, v) or b.shape != (v,) or lab.shape != (bsz, u1):
        raise ValueError(f"{name}: inconsistent shapes")
    if any(x.shape != (bsz, t, u1) for x in lattice):
        raise ValueError(f"{name}: lattice tensors must be [B, T, U+1]")
    why = width_error(enc.dtype, j)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if min(bsz, t, u1, v) == 0 or not 0 <= blank < v:
        raise ValueError(f"{name}: enc {tuple(enc.shape)}, pred {tuple(pred.shape)}, "
                         f"W {tuple(w.shape)}, blank {blank} outside the kernel")
    return bsz, t, u1, j, v


def _operands(enc, w, b, v_tile=_V_TILE):
    """W in the inputs' dtype and the float32 bias, padded to a multiple of
    the V tile (the kernels read no padded column into a result)."""
    v = w.shape[1]
    pad = (-v) % v_tile
    wk = F.pad(w.to(enc.dtype), (0, pad)).contiguous()
    bk = F.pad(b.float(), (0, pad)).contiguous()
    return wk, bk, v + pad


def _dtypes(enc, pred):
    """The C entries' (is_bf16, pred_bf16)."""
    return int(enc.dtype == torch.bfloat16), int(pred.dtype == torch.bfloat16)


def joint_lattice_fwd(enc, pred, w, b, lab, blank: int):
    """Kernel wrapper with the contract of ``joint_lattice_plain_fwd``: CPU
    tensors take the plain version, CUDA tensors launch the kernels or
    raise (float32 or bfloat16 contiguous enc and pred, int32 labels, J
    that ``width_error`` passes; J is zero-padded to a multiple of 128).
    Narrow route: one grid. Wide route: W^T once; per chunk of cells x and
    the logits product, whose epilogue writes each (V tile, cell)'s max
    and sum of exps and the picks; a last grid folds the tiles into logZ."""
    if enc.device.type == "cpu":
        return joint_lattice_plain_fwd(enc, pred, w, b, lab, blank)
    bsz, t, u1, _, v = _check("joint_lattice_fwd", enc, pred, w, b, lab, blank)
    enc, pred, w = pad_join(enc, pred, w)
    j = enc.shape[2]
    wk, bk, vp = _operands(enc, w, b, _FWD_V_TILE)
    dev, m = enc.device, bsz * t * u1
    lpb, lpe, logz = (torch.empty((bsz, t, u1), dtype=torch.float32, device=dev)
                      for _ in range(3))
    P = cuda_build.ptr
    grids = ctypes.c_int(0)
    common = (P(enc), P(pred), P(wk), P(bk), P(lab), P(lpb), P(lpe), P(logz))
    if route(enc.dtype, j) == "wide":
        f32 = enc.dtype == torch.float32
        chunk = _wide_chunk(m, vp, 8 if f32 else 2)
        wt, xbuf = _wide_scratch(enc, vp * j), _wide_scratch(enc, chunk * j)
        part = torch.empty((2, fwd_tiles(vp, f32), m), dtype=torch.float32, device=dev)
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_fwd_wide", n_ptrs=13,
                                      n_ints=10)
        err = fn(*common, P(wt), P(xbuf), P(part), ctypes.addressof(grids),
                 cuda_build.stream_ptr(enc), bsz, t, u1, j, v, vp, blank, chunk,
                 *_dtypes(enc, pred))
    else:
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_fwd", n_ptrs=10, n_ints=9)
        err = fn(*common, ctypes.addressof(grids), cuda_build.stream_ptr(enc), bsz, t, u1, j, v,
                 vp, blank, *_dtypes(enc, pred))
    joint_lattice_fwd.launches += grids.value
    cuda_build.check(err, "joint_lattice_fwd")
    return lpb, lpe, logz


def fwd_tiles(vp: int, f32: bool) -> int:
    """V tiles of the wide forward's logits product (128 columns in float32,
    256 in bf16): the partials hold one (max, sum) pair per tile and cell."""
    return -(-vp // (128 if f32 else 256))


def _wide_chunk(m: int, vp: int, elem: int) -> int:
    """Cells per chunk of the wide route: a multiple of ``_WIDE_TILE``
    whose dl ([chunk, Vp], ``elem`` bytes a value: 2 in bf16, 8 for
    float32's tf32 hi and lo) stays within ``_WIDE_DL_BYTES`` (the forward
    takes the backward's chunks); M rounded up where all of it fits."""
    fit = _WIDE_DL_BYTES // (vp * elem) // _WIDE_TILE * _WIDE_TILE
    return max(_WIDE_TILE, min(fit, -(-m // _WIDE_TILE) * _WIDE_TILE))


def _wide_scratch(enc, n: int):
    """n values of a wide-route operand in enc's dtype (float32: twice n,
    tf32 hi then lo)."""
    f32 = enc.dtype == torch.float32
    return torch.empty((2 * n if f32 else n,), dtype=enc.dtype, device=enc.device)


def joint_lattice_bwd_xp(enc, pred, w, b, lab, logz, g_blank, g_emit, blank: int):
    """Kernel wrapper with the contract of ``joint_lattice_plain_bwd_xp``:
    dpre = (dl W^T)(1 - x^2) per cell into a float32 scratch [B T (U+1),
    J] (one grid on the narrow kernels; on the wide route a logits product
    and a dX product per chunk of cells), then a last grid sums it over u
    and over t."""
    if enc.device.type == "cpu":
        return joint_lattice_plain_bwd_xp(enc, pred, w, b, lab, logz, g_blank, g_emit, blank)
    lattice = (logz, g_blank, g_emit)
    bsz, t, u1, j0, v = _check("joint_lattice_bwd_xp", enc, pred, w, b, lab, blank, lattice)
    enc, pred, w = pad_join(enc, pred, w)
    j = enc.shape[2]
    wk, bk, vp = _operands(enc, w, b)
    dev, m = enc.device, bsz * t * u1
    dpre = torch.empty((m, j), dtype=torch.float32, device=dev)
    d_enc = torch.empty((bsz, t, j), dtype=torch.float32, device=dev)
    d_pred = torch.empty((bsz, u1, j), dtype=torch.float32, device=dev)
    P = cuda_build.ptr
    grids = ctypes.c_int(0)
    common = (P(enc), P(pred), P(wk), P(bk), P(lab), P(logz), P(g_blank), P(g_emit))
    if route(enc.dtype, j, "bwd") == "wide":
        f32 = enc.dtype == torch.float32
        chunk = _wide_chunk(m, vp, 8 if f32 else 2)
        wt = _wide_scratch(enc, vp * j)
        wn = _wide_scratch(enc, j * vp) if f32 else None
        xbuf, dlbuf = _wide_scratch(enc, chunk * j), _wide_scratch(enc, chunk * vp)
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_bwd_xp_wide", n_ptrs=17,
                                      n_ints=10)
        err = fn(*common, P(wt), None if wn is None else P(wn), P(xbuf), P(dlbuf), P(dpre),
                 P(d_enc), P(d_pred), ctypes.addressof(grids), cuda_build.stream_ptr(enc),
                 bsz, t, u1, j, v, vp, blank, chunk, *_dtypes(enc, pred))
    else:
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_bwd_xp", n_ptrs=13,
                                      n_ints=9)
        err = fn(*common, P(dpre), P(d_enc), P(d_pred), ctypes.addressof(grids),
                 cuda_build.stream_ptr(enc), bsz, t, u1, j, v, vp, blank, *_dtypes(enc, pred))
    joint_lattice_bwd_xp.launches += grids.value
    cuda_build.check(err, "joint_lattice_bwd_xp")
    return d_enc[..., :j0], d_pred[..., :j0]


def _bwd_w_chunks(m: int, v: int) -> int:
    """Chunks of the M cells in ``joint_lattice_bwd_w``'s main grid (one
    block per V tile and chunk): enough for ``_BWD_W_BLOCKS`` blocks, and
    for at most ``_BWD_W_ROWS`` cells per chunk, whose sequential float32
    sum into a partial dW then parts from an exact sum by ~1e-5 of its
    scale (the chunks' partials are summed in a further grid)."""
    n_vt = -(-v // _V_TILE)
    return max(1, min(_MAX_CHUNKS, max(-(-_BWD_W_BLOCKS // n_vt), -(-m // _BWD_W_ROWS))))


def _wide_splits(j: int, vp: int, f32: bool) -> int:
    """Ways the wide bwd_w's dW product splits its chunk's cells: enough
    for ``_BWD_W_BLOCKS`` blocks of 128 J rows x 128 (float32) or 256
    (bf16) V columns."""
    tiles = (j // _WIDE_TILE) * -(-vp // (128 if f32 else 256))
    return max(1, -(-_BWD_W_BLOCKS // tiles))


def joint_lattice_bwd_w(enc, pred, w, b, lab, logz, g_blank, g_emit, blank: int):
    """Kernel wrapper with the contract of ``joint_lattice_plain_bwd_w``.
    Narrow kernels: one grid writes x = tanh(enc + pred) [B T (U+1), J],
    the main grid the partial dW and dbias of each (V tile, chunk of
    rows), a third sums the chunks in order. Wide route: per chunk of
    cells x and x^T, the logits product writing dl^T and each row tile's
    dbias sums, the dW product adding into partials split over cells; a
    last grid sums the partials in order."""
    if enc.device.type == "cpu":
        return joint_lattice_plain_bwd_w(enc, pred, w, b, lab, logz, g_blank, g_emit, blank)
    lattice = (logz, g_blank, g_emit)
    bsz, t, u1, j0, v = _check("joint_lattice_bwd_w", enc, pred, w, b, lab, blank, lattice)
    enc, pred, w = pad_join(enc, pred, w)
    j = enc.shape[2]
    wk, bk, vp = _operands(enc, w, b)
    dev, m = enc.device, bsz * t * u1
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.empty((j, vp), **f32)
    db = torch.empty((vp,), **f32)
    P = cuda_build.ptr
    grids = ctypes.c_int(0)
    common = (P(enc), P(pred), P(wk), P(bk), P(lab), P(logz), P(g_blank), P(g_emit))
    if route(enc.dtype, j, "bwd") == "wide":
        is_f32 = enc.dtype == torch.float32
        chunk = _wide_chunk(m, vp, 8 if is_f32 else 2)
        n_split = _wide_splits(j, vp, is_f32)
        wt = _wide_scratch(enc, vp * j)
        xbuf, xtbuf = _wide_scratch(enc, chunk * j), _wide_scratch(enc, j * chunk)
        dlbuf = _wide_scratch(enc, vp * chunk)
        part = torch.empty((n_split, j, vp), **f32)
        dbpart = torch.empty((-(-m // _WIDE_TILE), vp), **f32)
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_bwd_w_wide", n_ptrs=18,
                                      n_ints=11)
        err = fn(*common, P(wt), P(xbuf), P(xtbuf), P(dlbuf), P(part), P(dbpart), P(dw), P(db),
                 ctypes.addressof(grids), cuda_build.stream_ptr(enc), bsz, t, u1, j, v, vp,
                 blank, chunk, n_split, *_dtypes(enc, pred))
    else:
        n_chunks = _bwd_w_chunks(m, v)
        xbuf = torch.empty((m, j), dtype=enc.dtype, device=dev)
        part = torch.empty((n_chunks, j, vp), **f32)
        dbpart = torch.empty((n_chunks, vp), **f32)
        fn = cuda_build.load_function("joint_lattice", "joint_lattice_bwd_w", n_ptrs=15,
                                      n_ints=10)
        err = fn(*common, P(xbuf), P(part), P(dbpart), P(dw), P(db), ctypes.addressof(grids),
                 cuda_build.stream_ptr(enc), bsz, t, u1, j, v, vp, blank, n_chunks,
                 *_dtypes(enc, pred))
    joint_lattice_bwd_w.launches += grids.value
    cuda_build.check(err, "joint_lattice_bwd_w")
    return dw[:j0, :v], db[:v]


joint_lattice_fwd.launches = 0
joint_lattice_bwd_xp.launches = 0
joint_lattice_bwd_w.launches = 0


class _JointLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc, pred, w, b, lab, blank):
        lpb, lpe, logz = joint_lattice_fwd(enc, pred, w, b, lab, blank)
        ctx.save_for_backward(enc, pred, w, b, lab, logz)
        ctx.blank = blank
        return lpb, lpe

    @staticmethod
    def backward(ctx, g_blank, g_emit):
        enc, pred, w, b, lab, logz = ctx.saved_tensors
        g = [torch.zeros_like(logz) if x is None else x.float().contiguous()
             for x in (g_blank, g_emit)]
        args = (enc, pred, w, b, lab, logz, *g, ctx.blank)
        d_enc, d_pred = joint_lattice_bwd_xp(*args)
        dw, db = joint_lattice_bwd_w(*args)
        return (d_enc.to(enc.dtype), d_pred.to(pred.dtype), dw.to(w.dtype), db.to(b.dtype),
                None, None)


def joint_lattice_log_probs(enc_proj, pred_proj, w_out, b_out, labels_padded, blank: int = 0):
    """(lp_blank, lp_emit) [B, T, U+1] float32 of the full-lattice joint
    through the kernels, differentiable with respect to enc_proj,
    pred_proj, w_out and b_out (the JAX ``joint_lattice_log_probs_pallas``;
    gradients in their inputs' dtypes). ``labels_padded`` [B, U+1]: label
    u+1 at row u, blank at row U."""
    lab = labels_padded.to(torch.int32).contiguous()
    return _JointLattice.apply(enc_proj.contiguous(), pred_proj.contiguous(), w_out, b_out, lab,
                               blank)
