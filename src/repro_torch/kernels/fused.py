"""The ``fused`` path of the port: blocked attention with a hand-written
backward, and the chunked SSD scan, in plain torch.

The twin of the reference's ``repro.kernels.fused``, which is plain jnp
and ``lax.scan`` (no Pallas), so no CUDA kernel backs it here either:

* :func:`fused_attention` is an online-softmax scan over blocks of
  ``block_kv`` keys that never materialises the (Sq x Skv) logits and
  never repeats K/V across GQA groups (grouped einsums over the layout
  (B, G, R, Sq, bk): G kv heads, R query heads each). It is a
  ``torch.autograd.Function`` whose backward is the reference's custom
  VJP (``_bwd``): only (q, k, v, out, lse) are saved, and each block's
  probabilities are recomputed from the row log-sum-exp. This is the
  path the trainer runs, since the hand-written kernels have no
  backward.
* :func:`fused_decode_attention`: grouped-einsum decode attention.
* :func:`fused_ssd_scan`: the SSD scan over chunks of ``chunk`` steps
  (the terms that do not read the carried state batched over all chunks,
  then a Python loop over chunks for the state; autograd through torch
  ops), falling back to the sequential plain version when ``chunk`` does
  not divide L, as the reference does.

Everything computes in float32 and casts the outputs (and gradients) to
the input dtypes. The key count must be a multiple of the block: the
reference's reshape fails otherwise, and this port raises
``ValueError`` rather than pad. One deliberate difference: the SSD's
intra-chunk decay mask takes its exponent through the causal mask
before the ``exp`` (the reference masks after it), which gives the same
values and keeps the backward finite where the reference's would be
``0 * inf``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

NEG_INF = -1e30
DEFAULT_BLOCK = 512


def _scale_of(d: int, scale) -> float:
    return float(d ** -0.5) if scale is None else float(scale)


def _block_of(skv: int, block_kv: int) -> int:
    bk = min(block_kv, skv)
    if skv % bk:
        raise ValueError(f"fused_attention: Skv {skv} is not a multiple of "
                         f"the key block {bk} (block_kv {block_kv}); the "
                         "reference's reshape fails there too")
    return bk


def _prep(q, k, v, scale: float):
    """q (B, Sq, H, D) -> float32 (B, Sq, G, R, D) times ``scale``; k, v
    upcast to float32."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).to(torch.float32) * scale
    return qg, k.to(torch.float32), v.to(torch.float32)


def _qpos(b: int, sq: int, skv: int, segment_pos, device):
    if segment_pos is not None:
        return segment_pos
    return (torch.arange(sq, device=device) + (skv - sq))[None, :] \
        .expand(b, sq)


def _mask(qpos, kpos, causal: bool, window: int):
    """(B, Sq, bk) bool: the keys each query sees."""
    mask = torch.ones(qpos.shape + kpos.shape, dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    return mask


def _forward(q, k, v, causal, window, softcap, scale, segment_pos, bk):
    """-> (out (B, Sq, H, D) in q's dtype, lse (B, G, R, Sq) float32)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg, kf, vf = _prep(q, k, v, scale)
    qpos = _qpos(b, sq, skv, segment_pos, q.device)
    shape = (b, hkv, h // hkv, sq)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(shape + (d,), dtype=torch.float32, device=q.device)
    for start in range(0, skv, bk):
        kpos = torch.arange(start, start + bk, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf[:, start:start + bk])
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(_mask(qpos, kpos, causal, window)[:, None, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vf[:, start:start + bk])
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc / l[..., None]                              # (B, G, R, Sq, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, m + torch.log(l)


def _backward(q, k, v, out, lse, dout, causal, window, softcap, scale,
              segment_pos, bk):
    """The reference's ``_bwd``: (dq, dk, dv) in the input dtypes."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg, kf, vf = _prep(q, k, v, scale)
    do = dout.reshape(b, sq, hkv, rep, d).permute(0, 2, 3, 1, 4) \
        .to(torch.float32)                                # (B, G, R, Sq, D)
    og = out.reshape(b, sq, hkv, rep, d).permute(0, 2, 3, 1, 4) \
        .to(torch.float32)
    delta = (do * og).sum(dim=-1)                         # (B, G, R, Sq)
    qpos = _qpos(b, sq, skv, segment_pos, q.device)
    dq = torch.zeros((b, sq, hkv, rep, d), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for start in range(0, skv, bk):
        kblk, vblk = kf[:, start:start + bk], vf[:, start:start + bk]
        kpos = torch.arange(start, start + bk, device=q.device)
        s_raw = torch.einsum("bqgrd,bkgd->bgrqk", qg, kblk)
        s = torch.tanh(s_raw / softcap) * softcap if softcap > 0 else s_raw
        mask = _mask(qpos, kpos, causal, window)[:, None, None]
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])                 # (B, G, R, Sq, bk)
        dvs.append(torch.einsum("bgrqk,bgrqd->bkgd", p, do))
        dp = torch.einsum("bgrqd,bkgd->bgrqk", do, vblk)
        ds = p * (dp - delta[..., None])
        if softcap > 0:
            # d/dx [softcap * tanh(x / softcap)] = 1 - tanh^2(x / softcap)
            ds = ds * (1.0 - torch.square(torch.tanh(s_raw / softcap)))
        ds = torch.where(mask, ds, 0.0)
        dks.append(torch.einsum("bgrqk,bqgrd->bkgd", ds, qg))  # pre-scale q
        dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", ds, kblk) * scale
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, segment_pos,
                block_kv):
        scale = _scale_of(q.shape[-1], scale)
        bk = _block_of(k.shape[1], block_kv)
        out, lse = _forward(q, k, v, causal, window, softcap, scale,
                            segment_pos, bk)
        ctx.save_for_backward(q, k, v, out, lse, segment_pos)
        ctx.args = (causal, window, softcap, scale, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_pos = ctx.saved_tensors
        causal, window, softcap, scale, bk = ctx.args
        dq, dk, dv = _backward(q, k, v, out, lse, dout, causal, window,
                               softcap, scale, segment_pos, bk)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    segment_pos: torch.Tensor | None = None,
                    block_kv: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Same semantics as ``ref.flash_attention_ref``: q (B, Sq, H, D); k,
    v (B, Skv, Hkv, D); ``segment_pos`` (B, Sq) query positions (default
    suffix-aligned). Returns (B, Sq, H, D) in q's dtype, differentiable
    in q, k and v (``segment_pos`` gets no gradient). Skv must be a
    multiple of ``min(block_kv, Skv)`` (``ValueError`` otherwise)."""
    return _FusedAttention.apply(q, k, v, bool(causal), int(window),
                                 float(softcap), scale, segment_pos,
                                 int(block_kv))


def fused_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_pos: torch.Tensor,
                           q_pos: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0, scale: float | None = None
                           ) -> torch.Tensor:
    """Grouped-einsum decode attention (GQA without repeating K/V). q:
    (B, H, D); caches (B, C, Hkv, D); kv_pos (B, C); q_pos (B,). Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(torch.float32) \
        * _scale_of(d, scale)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.to(torch.float32))
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window > 0:
        valid &= kv_pos > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def fused_ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   initial_state: torch.Tensor | None = None,
                   return_final_state: bool = False, chunk: int = 64):
    """The SSD scan chunk by chunk, in float32: per chunk the intra-chunk
    ``(C B^T ⊙ decay mask) (dt x)``, the inter-chunk ``exp(seg) C h_prev``
    and the state update ``h = exp(seg_last) h_prev + (dt x w)^T B``.
    Semantics of ``ref.ssd_scan_ref``; a length that ``min(chunk, L)``
    does not divide runs that sequential plain version instead, as the
    reference does.

    The reference computes every term inside its scan over chunks. Only
    the state carries from chunk to chunk, so here every term that does
    not read it is computed for all chunks at once (the same per-chunk
    products, batched over a chunk axis) and the Python loop over chunks
    runs only the carried part: the inter-chunk term and the update."""
    bsz, length, heads, hp = x.shape
    groups, n = b.shape[2], b.shape[3]
    rep = heads // groups
    chunk = min(chunk, length)
    if length % chunk:
        return ref.ssd_scan_ref(x, dt, a, b, c, d_skip,
                                initial_state=initial_state,
                                return_final_state=return_final_state)
    nc = length // chunk
    split = lambda t: t.reshape((bsz, nc, chunk) + t.shape[2:])
    xf = split(x.to(torch.float32))                       # (B, C, Q, H, P)
    dtf = split(dt.to(torch.float32))                     # (B, C, Q, H)
    bh = split(b.to(torch.float32).repeat_interleave(rep, dim=2))
    ch = split(c.to(torch.float32).repeat_interleave(rep, dim=2))
    seg = torch.cumsum(dtf * a.to(torch.float32), dim=2)  # (B, C, Q, H)
    xin = xf * dtf[..., None]                             # dt_j * x_j
    # intra-chunk: (C B^T ⊙ L) (dt x), every chunk at once
    cbm = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    ldec = seg.transpose(2, 3)                            # (B, C, H, Q)
    row = torch.arange(chunk, device=x.device)
    causal = row[:, None] >= row[None, :]
    # masked before the exp: above the diagonal the decay exponent is
    # positive and overflows at real widths, and the reference's
    # where(causal, exp(.), 0) then backpropagates 0 * inf = NaN; the
    # forward values are the same either way
    lmask = torch.exp(torch.where(causal, ldec[..., :, None]
                                  - ldec[..., None, :], -torch.inf))
    y = torch.einsum("bchqk,bckhp->bcqhp", cbm * lmask, xin) \
        + xf * d_skip.to(torch.float32)[:, None]
    # each chunk's own state contribution and decay
    seg_last = seg[:, :, -1]                              # (B, C, H)
    w = torch.exp(seg_last[:, :, None] - seg)             # (B, C, Q, H)
    contrib = torch.einsum("bcqhp,bcqhn->bchpn", xin * w[..., None], bh)
    decay = torch.exp(seg_last)[..., None, None]          # (B, C, H, 1, 1)
    gain = torch.exp(seg)[..., None]                      # (B, C, Q, H, 1)
    h = torch.zeros((bsz, heads, hp, n), dtype=torch.float32,
                    device=x.device) if initial_state is None \
        else initial_state.to(torch.float32)
    y_off = []
    for k in range(nc):
        y_off.append(gain[:, k] * torch.einsum("bqhn,bhpn->bqhp",
                                               ch[:, k], h))
        h = decay[:, k] * h + contrib[:, k]
    y = (y + torch.stack(y_off, dim=1)).reshape(x.shape).to(x.dtype)
    return (y, h) if return_final_state else y
