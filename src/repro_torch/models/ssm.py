"""Mamba-2 block (SSD, state-space duality) of the port: prefill and
decode.

The reference is ``repro.models.ssm`` (arXiv:2405.21060 §7)::

  in_proj: d -> [z (d_in), x (d_in), B (G·N), C (G·N), dt (H)]
  causal depthwise conv (width 4) over [x, B, C], then SiLU
  dt = softplus(dt + dt_bias);  A = -exp(A_log)  (per head)
  y = SSD(x·heads, dt, A, B, C) + D ⊙ x
  out = out_proj( rmsnorm(y) * silu(z) )     (gated RMSNorm variant)

A config may give the head count (``ssm_heads``; the inner width is then
heads x head_dim, not expand x d_model) and the published Mamba-2 gate
order (``ssm_gate_first``: rmsnorm(y * silu(z)) over ``ssm_groups``
groups, as Nemotron-H's ``MambaRMSNormGated``); the gated norm takes its
epsilon from ``norm_eps`` where the config sets one.

Plain functions on dicts of tensors, with the reference's layouts and
dtype steps: the prefill conv sums its taps in the input dtype in the
order ``ext[:, 0:L]·w0 + … + ext[:, W-1:L+W-1]·w_{W-1}``, adds the bias
in that dtype and applies SiLU in float32; the decode conv is a float32
einsum. The scan goes through ``repro_torch.kernels.ops.ssd_scan``:
``kernels="cuda"`` launches the hand-written kernel, ``"ref"`` runs its
plain version. Its x, B and C are slices of the conv output, so they are
made contiguous here (the kernel's wrapper takes nothing else).

Decode carries two pieces of state per layer, a conv buffer (B, W-1,
conv channels) in the model dtype and the SSM state (B, H, P, N) in
float32; ``decode_step`` updates both in place, as the attention layers
update their caches. Under ``kernels="cuda"`` on plain tensors its mixer
between in_proj and out_proj is three launches a layer: ``ops.
ssd_conv_step`` (the conv step over the in_proj output read in place,
and dt), ``ops.ssd_state_step`` (the state update, B and C by group) and
``ops.ssd_gated_norm``. Under ``"ref"`` / ``"fused"``, and for a DTensor
state (sharded by ``sharding.local_state_step``), the conv, dt's
softplus, the repeat of B and C over the heads and the gated norm are
plain ops around ``ops.ssd_step``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import _is_dtensor
from repro_torch.kernels import ops
from repro_torch.models import layers


def dims(cfg: ArchConfig) -> dict:
    if cfg.ssm_heads:
        n_heads = cfg.ssm_heads
        d_in = n_heads * cfg.ssm_head_dim
    else:
        d_in = cfg.ssm_expand * cfg.d_model
        n_heads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return dict(d_in=d_in, n_heads=n_heads, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state, groups=cfg.ssm_groups,
                conv_ch=conv_ch, conv_w=cfg.conv_width)


def init(init: layers.Init, cfg: ArchConfig, dtype) -> dict:
    """The reference's shapes and init: projections Normal(0, 1/fan_in)
    in ``dtype``, conv taps 0.1 x Normal(0, 1) in ``dtype`` with a zero
    bias, and in float32 dt_bias 0, a_log = log(linspace(1, 16, H)),
    d_skip 1 and the gated norm's scale 0."""
    d = cfg.d_model
    dd = dims(cfg)
    proj_out = 2 * dd["d_in"] + 2 * dd["groups"] * dd["state"] \
        + dd["n_heads"]
    h = dd["n_heads"]
    return {
        "in_proj": init.dense((d, proj_out), d, dtype),
        "conv_w": init.normal((dd["conv_w"], dd["conv_ch"]), 0.1, dtype),
        "conv_b": init.full((dd["conv_ch"],), 0.0, dtype),
        "dt_bias": init.full((h,), 0.0),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=init.device)),
        "d_skip": init.full((h,), 1.0),
        "norm": layers.rmsnorm_init(init, dd["d_in"]),
        "out_proj": init.dense((dd["d_in"], d), dd["d_in"], dtype),
    }


def _split(cfg: ArchConfig, proj: torch.Tensor):
    """in_proj output -> (z, x, B, C, dt) along the last axis."""
    dd = dims(cfg)
    gn = dd["groups"] * dd["state"]
    return torch.split(proj, [dd["d_in"], dd["d_in"], gn, gn,
                              dd["n_heads"]], dim=-1)


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 u: torch.Tensor, buf: torch.Tensor | None = None,
                 silu: bool = True):
    """Depthwise causal conv, then SiLU unless ``silu`` is False (Mamba
    applies it, Griffin does not). u: (B, L, C); buf: the W-1 inputs
    before u, or None (zeros). Returns (y (B, L, C) in u's dtype, the
    last W-1 inputs as a new contiguous buffer for decode)."""
    w = conv_w.shape[0]
    length = u.shape[1]
    if buf is None:
        pad = torch.zeros((u.shape[0], w - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = buf.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                     # (B, L+W-1, C)
    y = ext[:, 0:length] * conv_w[0]
    for i in range(1, w):
        y = y + ext[:, i:i + length] * conv_w[i]
    y = (y + conv_b).to(torch.float32)
    if silu:
        y = F.silu(y)
    new_buf = ext[:, ext.shape[1] - (w - 1):].clone(
        memory_format=torch.contiguous_format)
    return y.to(u.dtype), new_buf


def _heads(cfg: ArchConfig, conv_out: torch.Tensor):
    """Conv output (B, L, conv_ch) -> contiguous x (B, L, H, P), B and C
    (B, L, G, N)."""
    dd = dims(cfg)
    bsz, length = conv_out.shape[:2]
    gn = dd["groups"] * dd["state"]
    xs, b, c = torch.split(conv_out, [dd["d_in"], gn, gn], dim=-1)
    return (xs.reshape(bsz, length, dd["n_heads"], dd["head_dim"])
            .contiguous(),
            b.reshape(bsz, length, dd["groups"], dd["state"]).contiguous(),
            c.reshape(bsz, length, dd["groups"], dd["state"]).contiguous())


def _gate_out(params: dict, cfg: ArchConfig, y: torch.Tensor,
              z: torch.Tensor, dtype) -> torch.Tensor:
    """out_proj(rmsnorm(y) * silu(z)), the SiLU in float32 cast to the
    model dtype; under ``ssm_gate_first`` out_proj(rmsnorm(y * silu(z)))
    with each of the ``ssm_groups`` groups of the width normed on
    its own, in float32 and cast once."""
    eps = cfg.norm_eps or 1e-6
    if not cfg.ssm_gate_first:
        y = layers.rmsnorm(params["norm"], y, eps) \
            * F.silu(z.to(torch.float32)).to(dtype)
        return layers.matmul(y, params["out_proj"])
    g = (y.to(torch.float32) * F.silu(z.to(torch.float32))) \
        .unflatten(-1, (cfg.ssm_groups, -1))
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    y = (g.flatten(-2) * (1.0 + params["norm"]["scale"])).to(dtype)
    return layers.matmul(y, params["out_proj"])


def forward(params: dict, cfg: ArchConfig, x: torch.Tensor,
            state: dict | None = None, return_state: bool = False,
            kernels: str = "cuda"):
    """Full-sequence pass. x: (B, L, d). ``state`` ({"conv", "ssm"})
    resumes a sequence; ``return_state`` also returns the state after
    it."""
    dd = dims(cfg)
    bsz, length, _ = x.shape
    proj = layers.matmul(x, params["in_proj"])
    z, xs, b, c, dt = _split(cfg, proj)
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out, conv_buf = _causal_conv(
        params["conv_w"], params["conv_b"], conv_in,
        None if state is None else state["conv"])
    xh, bh, ch = _heads(cfg, conv_out)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, final = sharding.local_scan(
        lambda *args: ops.ssd_scan(*args, impl=kernels),
        xh, dt, a, bh, ch, params["d_skip"],
        None if state is None else state["ssm"], True)
    out = _gate_out(params, cfg, y.reshape(bsz, length, dd["d_in"]), z,
                    x.dtype)
    if return_state:
        return out, {"conv": conv_buf, "ssm": final}
    return out


def init_state(cfg: ArchConfig, batch: int, dtype, device="cuda") -> dict:
    dd = dims(cfg)
    return {
        "conv": torch.zeros((batch, dd["conv_w"] - 1, dd["conv_ch"]),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, dd["n_heads"], dd["head_dim"],
                            dd["state"]), dtype=torch.float32,
                           device=device),
    }


def _mixer_kernels(params: dict, cfg: ArchConfig, proj: torch.Tensor,
                   state: dict) -> torch.Tensor:
    """The decode mixer from the in_proj output proj (B, proj_out) to
    out_proj's input (B, d_in) in three hand-written launches, the state
    updated in place: the conv step and dt, the state step (x, B and C
    views of the conv output), the gated norm in the config's gate
    order."""
    dd = dims(cfg)
    d_in, ch = dd["d_in"], dd["conv_ch"]
    gn = dd["groups"] * dd["state"]
    conv, dt = ops.ssd_conv_step(
        proj[:, d_in:d_in + ch], proj[:, d_in + ch:], state["conv"],
        params["conv_w"], params["conv_b"], params["dt_bias"], impl="cuda")
    y = ops.ssd_state_step(
        state["ssm"], dt, params["a_log"],
        conv[:, :d_in].unflatten(1, (dd["n_heads"], dd["head_dim"])),
        conv[:, d_in:d_in + gn].unflatten(1, (dd["groups"], dd["state"])),
        conv[:, d_in + gn:].unflatten(1, (dd["groups"], dd["state"])),
        params["d_skip"], impl="cuda")
    return ops.ssd_gated_norm(
        y.flatten(1), proj[:, :d_in], params["norm"]["scale"],
        cfg.ssm_groups if cfg.ssm_gate_first else 1, cfg.ssm_gate_first,
        cfg.norm_eps or 1e-6, impl="cuda")


def decode_step(params: dict, cfg: ArchConfig, x: torch.Tensor,
                state: dict, kernels: str = "cuda"):
    """One-token step, O(1) in the sequence length. x: (B, 1, d).
    Returns (out (B, 1, d), state), with ``state["conv"]`` and
    ``state["ssm"]`` updated in place. The state recurrence is
    ``ops.ssd_step`` under ``kernels`` (``"ref"`` / ``"fused"``: its
    plain version) and the rest plain ops, or under ``"cuda"`` on plain
    tensors the three launches of ``_mixer_kernels``."""
    dd = dims(cfg)
    bsz = x.shape[0]
    proj = layers.matmul(x, params["in_proj"])          # (B, 1, proj_out)
    if kernels == "cuda" and not (_is_dtensor(x)
                                  or _is_dtensor(state["ssm"])):
        y = _mixer_kernels(params, cfg, proj[:, 0], state)
        return layers.matmul(y[:, None], params["out_proj"]), state
    z, xs, b, c, dt = _split(cfg, proj)
    conv_in = torch.cat([xs, b, c], dim=-1)              # (B, 1, C)
    buf = state["conv"]
    ext = torch.cat([buf.to(conv_in.dtype), conv_in], dim=1)
    w = params["conv_w"].shape[0]
    y = torch.einsum("bwc,wc->bc", ext[:, ext.shape[1] - w:]
                     .to(torch.float32),
                     params["conv_w"].to(torch.float32))
    y = F.silu(y + params["conv_b"].to(torch.float32))
    buf.copy_(ext[:, ext.shape[1] - (w - 1):])

    gn = dd["groups"] * dd["state"]
    rep = dd["n_heads"] // dd["groups"]
    xs1 = y[:, :dd["d_in"]].reshape(bsz, dd["n_heads"], dd["head_dim"])
    b1 = y[:, dd["d_in"]:dd["d_in"] + gn].reshape(
        bsz, dd["groups"], dd["state"]).repeat_interleave(rep, dim=1)
    c1 = y[:, dd["d_in"] + gn:].reshape(
        bsz, dd["groups"], dd["state"]).repeat_interleave(rep, dim=1)

    dt1 = F.softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    yh = sharding.local_state_step(
        lambda *args: ops.ssd_step(*args, impl=kernels), state["ssm"], dt1,
        a, xs1, b1, c1, params["d_skip"])
    yh = yh.reshape(bsz, 1, dd["d_in"]).to(x.dtype)
    return _gate_out(params, cfg, yh, z, x.dtype), state
