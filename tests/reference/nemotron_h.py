"""Plain float32 reference of a Nemotron-H hybrid stack (NVIDIA-Nemotron-
3-Nano-30B-A3B), for the tier-1 tests.

The whole forward of the published equations (``modeling_nemotron_h.py``
of the model's repository): the token embedding, then per character of
the pattern one sublayer behind its own RMSNorm and a residual add,

* ``M``: a Mamba-2 mixer: in_proj to [z, x, B, C, dt], a causal
  depthwise conv with its bias and SiLU over [x, B, C], dt =
  softplus(dt + dt_bias), A = -exp(A_log), the recurrence h_t =
  exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t (head h
  reading group h // (H / G)), the gated norm rmsnorm(y * silu(z)) over
  ``ssm_groups`` groups, out_proj;
* ``E``: experts: float32 sigmoid scores of a float32 router, each
  token's top k by score + selection bias, their scores divided by their
  sum (+ 1e-20) and multiplied by the routed scale, each expert
  down(relu(up(x))²), and a shared expert of the same form added
  unscaled;
* ``*``: attention, grouped key / value heads, causal, no bias and no
  rotary embedding;

then the final RMSNorm and the untied head. Plain ``torch`` in float32
with TF32 off, a token at a time where the published code loops: no
kernel, no cache, no batching of the port, nothing imported from it.

Departures, each of the same mathematics: the recurrence is the
sequential scan (the published code runs it in chunks of 128, the
port's kernel in chunks of 64); norms are ``x * (1 + scale)`` where the
published RMSNorm keeps ``weight`` (the port's parametrisation, init
scale 0 for weight 1); every sum is taken in float32 where the published
code rounds to bf16 between some steps. The published code applies no
rotary embedding although the config carries ``rope_theta``: none here.
Weights are the port's tree (``repro_torch`` layouts: ``wq`` (d, H, hd),
``in_proj`` (d, out), experts ``wi`` (E, d, f) and ``wo`` (E, f, d)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f(t):
    return t.to(torch.float32)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + _f(scale))


def mamba(m: dict, cfg, u: torch.Tensor, norm_groups: int = 0
          ) -> torch.Tensor:
    """The Mamba-2 mixer on the normed stream u (B, L, D); the gated norm
    over ``norm_groups`` groups (0: ``ssm_groups``, the published
    ``group_size`` d_in / n_groups)."""
    heads, hp = cfg.ssm_heads, cfg.ssm_head_dim
    n, g, w = cfg.ssm_state, cfg.ssm_groups, cfg.conv_width
    d_in = heads * hp
    bsz, length, _ = u.shape
    proj = u @ _f(m["in_proj"])
    z, xs, bb, cc, dt = torch.split(
        proj, [d_in, d_in, g * n, g * n, heads], dim=-1)
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    ext = F.pad(conv_in, (0, 0, w - 1, 0))
    cw = _f(m["conv_w"])
    conv = sum(ext[:, i:i + length] * cw[i] for i in range(w))
    conv = F.silu(conv + _f(m["conv_b"]))
    xs, bb, cc = torch.split(conv, [d_in, g * n, g * n], dim=-1)
    x = xs.reshape(bsz, length, heads, hp)
    rep = heads // g
    b = bb.reshape(bsz, length, g, n).repeat_interleave(rep, dim=2)
    c = cc.reshape(bsz, length, g, n).repeat_interleave(rep, dim=2)
    dt = F.softplus(dt + _f(m["dt_bias"]))
    a = -torch.exp(_f(m["a_log"]))
    h = torch.zeros(bsz, heads, hp, n)
    ys = []
    for t in range(length):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, c[:, t]))
    y = torch.stack(ys, 1) + x * _f(m["d_skip"])[:, None]
    y = (y.reshape(bsz, length, d_in) * F.silu(z)) \
        .unflatten(-1, (norm_groups or cfg.ssm_groups, -1))
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg.norm_eps)
    y = y.flatten(-2) * (1.0 + _f(m["norm"]["scale"]))
    return y @ _f(m["out_proj"])


def route(e: dict, cfg, x: torch.Tensor):
    """Per token of x (T, D): (its k experts in order of choice, their
    weights (T, k))."""
    scores = torch.sigmoid(x @ _f(e["router"]))
    choice = scores + _f(e["select_bias"])
    idx = torch.sort(choice, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def relu2_mlp(x, wi, wo):
    return torch.relu(x @ _f(wi)).square() @ _f(wo)


def experts(e: dict, cfg, u: torch.Tensor) -> torch.Tensor:
    """The expert sublayer on the normed stream u (B, L, D)."""
    x = u.reshape(-1, u.shape[-1])
    idx, w = route(e, cfg, x)
    y = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            k = int(idx[t, j])
            y[t] += w[t, j] * relu2_mlp(x[t], e["wi"][k], e["wo"][k])
    y = y + relu2_mlp(x, e["shared"]["wi"], e["shared"]["wo"])
    return y.reshape(u.shape)


def attention(a: dict, u: torch.Tensor) -> torch.Tensor:
    """Causal GQA on the normed stream u (B, S, D), no rotary."""
    s = u.shape[1]
    q = torch.einsum("bsd,dhk->bshk", u, _f(a["wq"]))
    k = torch.einsum("bsd,dhk->bshk", u, _f(a["wk"]))
    v = torch.einsum("bsd,dhk->bshk", u, _f(a["wv"]))
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    att = torch.einsum("bqhk,bshk->bhqs", q, k) * q.shape[-1] ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqs,bshk->bqhk", att, v)
    return torch.einsum("bqhk,hkd->bqd", o, _f(a["wo"]))


def forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> float32 logits (B, S, V)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            x = _f(params["embed"])[tokens]
            for c, p in zip(cfg.hybrid_pattern, params["layers"]):
                u = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
                if c == "M":
                    x = x + mamba(p["mixer"], cfg, u)
                elif c == "E":
                    x = x + experts(p["moe"], cfg, u)
                else:
                    x = x + attention(p["attn"], u)
            x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
            return x @ _f(params["lm_head"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
