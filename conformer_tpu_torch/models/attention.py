"""Relative-position multi-head self-attention (JAX ``models/attention.py``).

The relative paths of the JAX ``mhsa`` for a full-utterance forward:
  - skew: the Transformer-XL table slice projected by ``linear_pos`` and
    shifted into place with the pad+reshape trick (``_rel_skew``);
  - decomposed: the exact angle-addition factorisation of the same bias,
    bd = AB F^T with (AB, F) from ``rel_features``;
  - kernel: the same factorisation inside the fused flash-attention kernel
    (``ops/rel_attention.py``, differentiable), taken as in JAX when
    ``use_pallas`` is set and both ``rel_positions`` and a mask are given.
Training adds dropout on the attention probabilities: drawn from the
generator in the plain paths, inside the kernel from a seed drawn on the
device in the kernel path.

Streaming passes a right-aligned KV cache (``AttnCache``): keys and values
are ``cache ++ new`` in every path, the kernel's included, and the mask
and positions cover the cache slots. With neither positions nor a table
the attention is absolute (the attention decoder's and the encoder's
``use_relative=False`` mode): no position term, float32 scores.

The reference-parity modes (``rel_mode`` "ref_abs" / "ref_batch") pass
``pos_ref``, a matrix of absolute position rows: the bias is q_v .
linear_pos(pos_ref) with no relative shift, by plain products, never
through the kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import embedding, layers
from .layers import Params


class AttnCache(NamedTuple):
    """Right-aligned KV cache: the newest frame sits at index size-1."""

    k: torch.Tensor        # [B, H, C, dk]
    v: torch.Tensor        # [B, H, C, dk]
    length: torch.Tensor   # int32, scalar or [B]: valid trailing slots


def init_attn_cache(batch: int, heads: int, cache_size: int, head_dim: int,
                    dtype=torch.float32, device=None) -> AttnCache:
    shape = (batch, heads, cache_size, head_dim)
    return AttnCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_mhsa(gen, dim: int, num_heads: int, relative: bool = True) -> Params:
    """The four projections and, when ``relative``, ``linear_pos`` and the
    position biases (the attention decoder's layers are absolute)."""
    p: Params = {
        "linear_q": layers.init_dense(gen, dim, dim),
        "linear_k": layers.init_dense(gen, dim, dim),
        "linear_v": layers.init_dense(gen, dim, dim),
        "linear_out": layers.init_dense(gen, dim, dim),
    }
    if relative:
        head_dim = dim // num_heads
        bound = math.sqrt(6.0 / (num_heads + head_dim))   # xavier_uniform
        p["linear_pos"] = layers.init_dense(gen, dim, dim, use_bias=False)
        p["pos_bias_u"] = layers.uniform(gen, (num_heads, head_dim), bound)
        p["pos_bias_v"] = layers.uniform(gen, (num_heads, head_dim), bound)
    return p


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def _rel_skew(bd_full: torch.Tensor, k_len: int) -> torch.Tensor:
    """[B,H,Tq,Tq+Tk-1] (descending distance) -> [B,H,Tq,Tk]: row i takes
    entries (Tq-1-i) + j, by padding one column, flattening and slicing."""
    b, h, q_len, p = bd_full.shape
    flat = torch.nn.functional.pad(bd_full, (0, 1)).reshape(b, h, q_len * (p + 1))
    flat = flat[:, :, q_len - 1:q_len - 1 + q_len * p]
    return flat.reshape(b, h, q_len, p)[..., :k_len]


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Float32 softmax over keys; masked entries -1e9 in, 0 out."""
    sf = scores.float()
    if mask is not None:
        sf = torch.where(mask, sf, torch.full_like(sf, -1e9))
    attn = torch.softmax(sf, dim=-1)
    if mask is not None:
        attn = torch.where(mask, attn, torch.zeros_like(attn))
    return attn


def rel_features(
    p: Params, q_v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(ab [B,H,Tq,D], k_feats [Tk,D]) such that the relative bias is
    ab @ k_feats^T; D = d_model, not the head width. Under a model axis
    q_v holds this rank's heads and ``linear_pos`` their columns; D stays
    the model width, its input axis."""
    bsz, h, tq, dk = q_v.shape
    d_model = p["linear_pos"]["kernel"].shape[0]
    w = p["linear_pos"]["kernel"].to(q_v.dtype).reshape(d_model, h, dk)
    c = torch.einsum("bhtd,ihd->bhti", q_v, w)
    ce, co = c[..., 0::2], c[..., 1::2]
    freqs = embedding.rel_freqs(d_model, q_v.device)
    ang_q = q_pos.float()[:, None] * freqs[None, :]
    sq = torch.sin(ang_q).to(q_v.dtype)
    cq = torch.cos(ang_q).to(q_v.dtype)
    alpha = ce * sq + co * cq
    beta = -ce * cq + co * sq
    ab = torch.cat([alpha, beta], dim=-1)
    ang_k = k_pos.float()[:, None] * freqs[None, :]
    k_feats = torch.cat([torch.cos(ang_k), torch.sin(ang_k)], dim=-1).to(q_v.dtype)
    return ab, k_feats


def mhsa(
    p: Params,
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    attn_mask: torch.Tensor | None,
    *,
    num_heads: int,
    pos_emb: torch.Tensor | None = None,
    rel_positions: tuple[torch.Tensor, torch.Tensor] | None = None,
    pos_ref: torch.Tensor | None = None,
    use_pallas: bool = False,
    cache: AttnCache | None = None,
    dropout_rate: float = 0.0,
    gen: torch.Generator | None = None,
    deterministic: bool = True,
    kv_gather=None,
    model_shard=None,
) -> tuple[torch.Tensor, AttnCache | None]:
    """Multi-head attention, x_q [B,Tq,D], x_kv [B,Tkv,D] ->
    (out [B,Tq,D], new cache or None), as in JAX. attn_mask bool [B|1, Tq, Tk] (True = attend) or None;
    pos_emb [Tq+Tk-1, D] is the descending-distance table slice (skew);
    rel_positions (q_pos [Tq], k_pos [Tk]) feed the factorised bias;
    pos_ref [Bp, P, D] (the reference-parity modes) takes precedence over
    both: the bias is q_v . linear_pos(pos_ref), P = Tk (absolute key
    positions, Bp = 1 or B) or P = 1 with Bp = B (pe[batch index],
    broadcast over the keys), in float32 sums, never through the kernel;
    none of the three: absolute attention, scores = q k^T / sqrt(dk).
    With ``cache`` (C slots), Tk = C + Tkv: keys and values are ``cache ++
    new``, the mask and positions must cover the cache slots
    (``cache_valid_mask``), and the new cache holds the trailing C
    frames, ``length = min(length + Tkv, C)``.
    ``use_pallas`` keeps the JAX flag's name: it selects the CUDA kernel.
    Dropout at ``dropout_rate`` on the attention probabilities draws from
    ``gen``: in the kernel path one int32 seed, drawn on the device as JAX
    draws it from ``rng``, from which the kernels hash the keep-mask.
    ``kv_gather`` maps a time shard's K or V [B, H, Tkv, dk] to the whole
    sequence's (sequence parallelism, ``parallel/sequence.py``); the mask
    and positions then cover every key.
    ``model_shard`` (``parallel/tensor.py``): this rank computes its heads
    only (q, k, v and pos columns, pos_bias rows, linear_out rows), the
    kernel hashing its dropout mask at the global head index, the plain
    paths drawing the whole mask and keeping its heads; linear_out's bias
    is added once, after the sum over "model".
    """
    d_model = x_q.shape[-1]
    head_dim = d_model // num_heads
    heads, h_off = num_heads, 0
    if model_shard is not None:
        heads, h_off = model_shard.heads(num_heads)
        same = x_kv is x_q
        x_q = model_shard.copy_in(x_q)
        x_kv = x_q if same else model_shard.copy_in(x_kv)
    q = _split_heads(layers.dense(p["linear_q"], x_q), heads)
    k = _split_heads(layers.dense(p["linear_k"], x_kv), heads)
    v = _split_heads(layers.dense(p["linear_v"], x_kv), heads)
    if kv_gather is not None:
        k, v = kv_gather(k), kv_gather(v)
    new_cache = None
    if cache is not None:
        size = cache.k.shape[2]
        k = torch.cat([cache.k.to(k.dtype), k], dim=2)
        v = torch.cat([cache.v.to(v.dtype), v], dim=2)
        new_cache = AttnCache(
            k=k[:, :, k.shape[2] - size:], v=v[:, :, v.shape[2] - size:],
            length=torch.clamp(cache.length + x_kv.shape[1], max=size),
        )
    scale = 1.0 / math.sqrt(head_dim)
    attend = dict(dropout_rate=dropout_rate, gen=gen, deterministic=deterministic,
                  new_cache=new_cache, model_shard=model_shard)
    if pos_ref is not None or rel_positions is not None or pos_emb is not None:
        bias_u = p["pos_bias_u"].narrow(0, h_off, heads).to(q.dtype)[None, :, None, :]
        bias_v = p["pos_bias_v"].narrow(0, h_off, heads).to(q.dtype)[None, :, None, :]
    if pos_ref is not None:
        q_u = q + bias_u
        q_v = q + bias_v
        ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
        p_proj = layers.dense(p["linear_pos"], pos_ref.to(x_q.dtype))
        p_proj = p_proj.reshape(*p_proj.shape[:2], heads, head_dim)   # [Bp, P, H, dk]
        bd = torch.einsum("bhid,bphd->bhip", q_v.float(), p_proj.float())
        return _attend(p, (ac + bd) * scale, attn_mask, v, **attend)
    if rel_positions is None and pos_emb is None:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        return _attend(p, scores, attn_mask, v, **attend)
    q_u = q + bias_u
    q_v = q + bias_v

    if use_pallas and rel_positions is not None and attn_mask is not None:
        from ..ops.rel_attention import rel_flash_attention

        ab, k_feats = rel_features(p, q_v, *rel_positions, heads)
        mask_b = attn_mask.expand(q.shape[0], *attn_mask.shape[1:])
        live = not deterministic and dropout_rate > 0.0
        seed = None
        if live:
            if gen is None:
                raise ValueError("attention dropout in training needs a torch.Generator")
            seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=q.device,
                                 dtype=torch.int32)
        out = rel_flash_attention(
            q_u.contiguous(), ab.contiguous(), k.contiguous(), v.contiguous(),
            k_feats.contiguous(), mask_b.contiguous(), scale=scale,
            dropout_rate=dropout_rate if live else 0.0, seed=seed,
            h_total=num_heads, h_offset=h_off,
        )
        return _finish(p, out, new_cache, model_shard)

    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    if rel_positions is not None and pos_emb is None:
        ab, k_feats = rel_features(p, q_v, *rel_positions, heads)
        bd = torch.matmul(ab.float(), k_feats.float().transpose(-1, -2))
    else:
        p_proj = layers.dense(p["linear_pos"], pos_emb.to(x_q.dtype))
        p_proj = p_proj.reshape(-1, heads, head_dim)                 # [P, H, dk]
        # the position term stays in the compute dtype, as in JAX
        bd_full = torch.einsum("bhid,phd->bhip", q_v, p_proj)
        bd = _rel_skew(bd_full, k.shape[2]).float()
    return _attend(p, (ac + bd) * scale, attn_mask, v, **attend)


def _attend(p: Params, scores: torch.Tensor, attn_mask: torch.Tensor | None,
            v: torch.Tensor, *, dropout_rate: float, gen: torch.Generator | None,
            deterministic: bool, new_cache: AttnCache | None, model_shard):
    """Masked float32 softmax, dropout, the product with v in v's dtype,
    the output projection."""
    mask = attn_mask[:, None, :, :] if attn_mask is not None else None
    attn = _masked_softmax(scores, mask)
    if model_shard is None:
        attn = layers.dropout(gen, attn, dropout_rate, deterministic)
    else:
        attn = model_shard.dropout(gen, attn, dropout_rate, deterministic, dim=1)
    return _finish(p, torch.matmul(attn.to(v.dtype), v), new_cache, model_shard)


def _finish(p: Params, out: torch.Tensor, new_cache: AttnCache | None, model_shard=None):
    if model_shard is not None:
        return model_shard.dense_rows(p["linear_out"], _merge_heads(out)), new_cache
    return layers.dense(p["linear_out"], _merge_heads(out)), new_cache


def cache_valid_mask(cache: AttnCache, q_len: int) -> torch.Tensor:
    """bool [B|1, q_len, C + q_len]: cache slot j is valid iff j >= C -
    length (right-aligned, ``length`` scalar or per row); every chunk
    position is valid."""
    size = cache.k.shape[2]
    j = torch.arange(size + q_len, device=cache.k.device)
    length = cache.length.reshape(-1, 1)
    valid = torch.where(j[None, :] < size, j[None, :] >= size - length, True)
    return valid[:, None, :].expand(valid.shape[0], q_len, size + q_len)
