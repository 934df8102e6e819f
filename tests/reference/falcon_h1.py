"""Plain float32 reference of a Falcon-H1 stack (Falcon-H1-34B-Instruct),
for the tier-1 tests.

The whole forward of the published equations (``modeling_falcon_h1.py``
of ``transformers``: ``FalconH1DecoderLayer``, ``FalconH1Mixer``,
``FalconH1Attention``, ``FalconH1MLP``, ``compute_mup_vector``) on the
published, unfolded weights: a ``FalconH1ForCausalLM`` state dict under
its own names, with every muP multiplier applied where the published
code applies it. The token embedding times ``embedding_multiplier``,
then per layer, on one RMSNorm of the stream ``h``:

* the Mamba-2 mixer on ``h * ssm_in_multiplier``: in_proj, its output
  times the mup vector (z, x, B, C and dt segments by
  ``ssm_multipliers``), a causal depthwise conv with its bias and SiLU
  over [x, B, C], dt = softplus(dt + dt_bias), A = -exp(A_log), the
  recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t +
  D x_t (head h reading group h // (H / G)), the gated norm
  rmsnorm(y * silu(z)) over ``ssm_groups`` groups times its weight
  (``norm_before_gate`` false), out_proj, times ``ssm_out_multiplier``;
* attention on ``h * attention_in_multiplier``: q, k times
  ``key_multiplier``, v, rotary over the whole head (theta
  ``rope_theta``, ``rotate_half``), causal GQA at head_dim^-0.5, o_proj,
  times ``attention_out_multiplier``;

both added into the residual; then a second RMSNorm and the SwiGLU MLP
down(up(x) * silu(gate(x) * m_gate)) * m_down; the final RMSNorm and the
untied head times ``lm_head_multiplier``. Plain ``torch`` in float32
with TF32 off, a token at a time where the published code loops: no
kernel, no cache, no batching of the port, nothing imported from it.

Departures, each of the same mathematics: the recurrence is the
sequential scan (the published code runs it in chunks of
``mamba_chunk_size``, 128; the port's kernel in chunks of 64); every sum
is taken in float32 where the published code rounds to bf16 between
some steps.

``cfg`` gives the widths by the port's field names (``d_model``,
``n_heads``, ``n_kv_heads``, ``head_dim``, ``ssm_heads``,
``ssm_head_dim``, ``ssm_state``, ``ssm_groups``, ``conv_width``,
``norm_eps``, ``rope_theta``); ``mu`` the multipliers under their
published names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f(t):
    return t.to(torch.float32)


def rmsnorm(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * _f(weight)


def mup_vector(cfg, mu: dict) -> torch.Tensor:
    """``compute_mup_vector``: the in_proj output's multiplier per
    column."""
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    sizes = [d_in, d_in, gn, gn, cfg.ssm_heads]
    return torch.cat([torch.full((n,), float(m))
                      for n, m in zip(sizes, mu["ssm_multipliers"])])


def mamba(sd: dict, pre: str, cfg, mu: dict, h: torch.Tensor
          ) -> torch.Tensor:
    """The mixer's output (before ``ssm_out_multiplier``) for the normed
    stream h (B, L, D); ``pre`` the layer's ``mamba.`` prefix."""
    heads, hp = cfg.ssm_heads, cfg.ssm_head_dim
    n, g, w = cfg.ssm_state, cfg.ssm_groups, cfg.conv_width
    d_in = heads * hp
    bsz, length, _ = h.shape
    proj = (h * mu["ssm_in_multiplier"]) @ _f(sd[pre + "in_proj.weight"]).T
    proj = proj * mup_vector(cfg, mu)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * g * n, heads], dim=-1)
    ext = F.pad(xbc, (0, 0, w - 1, 0))
    taps = _f(sd[pre + "conv1d.weight"])[:, 0, :]           # (C, W)
    conv = sum(ext[:, i:i + length] * taps[:, i] for i in range(w))
    conv = F.silu(conv + _f(sd[pre + "conv1d.bias"]))
    xs, bb, cc = torch.split(conv, [d_in, g * n, g * n], dim=-1)
    x = xs.reshape(bsz, length, heads, hp)
    rep = heads // g
    b = bb.reshape(bsz, length, g, n).repeat_interleave(rep, dim=2)
    c = cc.reshape(bsz, length, g, n).repeat_interleave(rep, dim=2)
    dt = F.softplus(dt + _f(sd[pre + "dt_bias"]))
    a = -torch.exp(_f(sd[pre + "A_log"]))
    state = torch.zeros(bsz, heads, hp, n)
    ys = []
    for t in range(length):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t]))
    y = torch.stack(ys, 1) + x * _f(sd[pre + "D"])[:, None]
    y = (y.reshape(bsz, length, d_in) * F.silu(z)).unflatten(-1, (g, -1))
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg.norm_eps)
    y = y.flatten(-2) * _f(sd[pre + "norm.weight"])
    return y @ _f(sd[pre + "out_proj.weight"]).T


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def attention(sd: dict, pre: str, cfg, mu: dict, h: torch.Tensor
              ) -> torch.Tensor:
    """The attention's output (before ``attention_out_multiplier``) for
    the normed stream h (B, S, D); ``pre`` the layer's ``self_attn.``
    prefix."""
    bsz, s, _ = h.shape
    hd = cfg.head_dim
    u = h * mu["attention_in_multiplier"]
    q = (u @ _f(sd[pre + "q_proj.weight"]).T).reshape(bsz, s, -1, hd)
    k = (u @ _f(sd[pre + "k_proj.weight"]).T).reshape(bsz, s, -1, hd) \
        * mu["key_multiplier"]
    v = (u @ _f(sd[pre + "v_proj.weight"]).T).reshape(bsz, s, -1, hd)
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.int64).float() / hd))
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv_freq
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    att = torch.einsum("bqhk,bshk->bhqs", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqs,bshk->bqhk", att, v).reshape(bsz, s, -1)
    return o @ _f(sd[pre + "o_proj.weight"]).T


def mlp(sd: dict, pre: str, mu: dict, h: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP with its two multipliers; ``pre`` the layer's
    ``feed_forward.`` prefix."""
    gm, dm = mu["mlp_multipliers"]
    y = (h @ _f(sd[pre + "up_proj.weight"]).T) \
        * F.silu((h @ _f(sd[pre + "gate_proj.weight"]).T) * gm)
    return (y @ _f(sd[pre + "down_proj.weight"]).T) * dm


def forward(sd: dict, cfg, mu: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> float32 logits (B, S, V) of the stack whose
    ``FalconH1ForCausalLM`` state dict is ``sd``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg.norm_eps
    try:
        with torch.no_grad():
            x = _f(sd["model.embed_tokens.weight"])[tokens] \
                * mu["embedding_multiplier"]
            for i in range(cfg.n_layers):
                pre = f"model.layers.{i}."
                h = rmsnorm(x, sd[pre + "input_layernorm.weight"], eps)
                m = mamba(sd, pre + "mamba.", cfg, mu, h) \
                    * mu["ssm_out_multiplier"]
                a = attention(sd, pre + "self_attn.", cfg, mu, h) \
                    * mu["attention_out_multiplier"]
                x = x + (m + a)
                x = x + mlp(sd, pre + "feed_forward.", mu, rmsnorm(
                    x, sd[pre + "pre_ff_layernorm.weight"], eps))
            x = rmsnorm(x, sd["model.final_layernorm.weight"], eps)
            return (x @ _f(sd["lm_head.weight"]).T) \
                * mu["lm_head_multiplier"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
