"""Relative-position flash attention, forward: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``conformer_tpu/ops/pallas/attention_kernel.py``
(``rel_flash_attention`` forward: ``_attn_fwd_kernel``, ``_fwd_impl``).
The kernel is ``csrc/rel_flash_attention.cu``; its source note gives the
bound and the design. ``rel_attention`` launches it for CUDA tensors and
takes ``rel_attention_plain`` only for CPU tensors (the tests' path).
Inference only: no dropout, no backward (the training slice adds both).
"""

from __future__ import annotations

import torch

from . import cuda_build

NEG_INF = -1e30
LSE_BIG = 1e30      # lse of a fully masked row
_BQ = _BK = 64      # query and key tile of the kernel


def rel_attention_plain(q_u, ab, k, v, k_feats, mask, *, scale: float):
    """softmax(((q+u)K^T + AB F^T) * scale, mask) V in float32.

    q_u, k, v [B,H,Tq|Tk,dk]; ab [B,H,Tq,D]; k_feats [Tk,D]; mask bool
    [B,Tq,Tk] (True = attend). Returns (out [B,H,Tq,dk] in v's dtype,
    lse float32 [B,H,Tq]); a fully masked row gives out 0 and lse 1e30.
    """
    s = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    s = s + torch.matmul(ab.float(), k_feats.float().transpose(-1, -2))
    m4 = mask[:, None, :, :]
    s = torch.where(m4, s * scale, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp_min(1e-30)
    live = l > 0.0
    out = torch.where(live, out, torch.zeros_like(out))
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, LSE_BIG))
    return out.to(v.dtype), lse[..., 0]


def rel_attention(q_u, ab, k, v, k_feats, mask, *, scale: float):
    """Kernel wrapper with the contract of ``rel_attention_plain``.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: float32 or bfloat16 inputs of one dtype, contiguous, dk <= 64.
    ``rel_attention.launches`` counts kernel launches.
    """
    if q_u.device.type == "cpu":
        return rel_attention_plain(q_u, ab, k, v, k_feats, mask, scale=scale)
    tensors = (q_u, ab, k, v, k_feats, mask)
    if q_u.device.type != "cuda" or any(t.device != q_u.device for t in tensors):
        raise ValueError("rel_attention: all inputs must be on one CUDA device")
    dtype = q_u.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dtype for t in (ab, k, v, k_feats)
    ):
        raise TypeError("rel_attention: inputs must all be float32 or all bfloat16")
    if mask.dtype != torch.bool:
        raise TypeError("rel_attention: mask must be bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rel_attention: inputs must be contiguous")
    b, h, tq, dk = q_u.shape
    tk, d = k_feats.shape
    if (
        ab.shape != (b, h, tq, d)
        or k.shape != (b, h, tk, dk)
        or v.shape != (b, h, tk, dk)
        or mask.shape != (b, tq, tk)
    ):
        raise ValueError("rel_attention: inconsistent shapes")
    smem = 4 * (_BQ * (dk + 1) + _BQ * (d + 1) + 2 * _BK * (dk + 1)
                + _BK * (d + 1) + _BQ * (_BK + 1))
    if dk > 64 or smem > cuda_build.SMEM_LIMIT or min(b, h, tq, tk) == 0:
        raise ValueError(f"rel_attention: shape {tuple(q_u.shape)}, D={d} "
                         "outside the kernel's tiles")

    fn = cuda_build.load_function("rel_flash_attention", "rel_flash_attention_fwd",
                                  n_ptrs=9, n_ints=7, n_floats=1)
    out = torch.empty((b, h, tq, dk), dtype=dtype, device=q_u.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q_u.device)
    P = cuda_build.ptr
    err = fn(
        P(q_u), P(ab), P(k), P(v), P(k_feats), P(mask), P(out), P(lse),
        cuda_build.stream_ptr(q_u), b, h, tq, tk, dk, d,
        int(dtype == torch.bfloat16), float(scale),
    )
    cuda_build.check(err, "rel_flash_attention")
    rel_attention.launches += 1
    return out, lse


rel_attention.launches = 0
