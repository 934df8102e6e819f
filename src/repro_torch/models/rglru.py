"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427): prefill and decode.

The reference is ``repro.models.rglru``, the Griffin 'recurrent block'::

  x, gate = in_proj(u)                    # d -> 2w
  x = causal_conv1d(x, width 4)           # no activation
  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)     (RG-LRU)
  out = out_proj( h ⊙ gelu(gate) )        # w -> d

with  a_t = exp(-c · softplus(Λ) · r_t),  r_t = σ(w_a ⊙ x_t + b_a),
      i_t = σ(w_x ⊙ x_t + b_x),  c = 8, the gates diagonal.

Plain functions on dicts of tensors, with the reference's layouts and
dtype steps. The prefill conv is ``ssm._causal_conv`` with ``silu=False``
(its sum in the input dtype, cast back to it); the decode step's conv is
a float32 einsum that stays float32, as in the reference, so in bf16 the
two paths round differently on purpose. The gates and the recurrence run
in float32.

The reference evaluates the recurrence with ``jax.lax.associative_scan``;
here it is a Hillis–Steele doubling scan of the same combine
``(a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, b_r + a_r b_l)``: ceil(log2 L)
rounds of whole-tensor torch ops (11 at L 2048), no kernel. The sums are
grouped differently from XLA's, so the two agree to float32 rounding, not
bit for bit. A carried state ``h0`` enters as ``b_0 + a_0 h0``, the
expression the reference's virtual step 0 evaluates.

Decode carries a conv buffer (B, W-1, w) in the model dtype and the
hidden state (B, w) in float32; ``decode_step`` updates both in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, ssm

_C = 8.0


def width(cfg: ArchConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def init(init: layers.Init, cfg: ArchConfig, dtype) -> dict:
    """The reference's shapes and init: projections Normal(0, 1/fan_in)
    in ``dtype``, conv taps 0.1 x Normal(0, 1) in ``dtype`` with a zero
    bias, and in float32 zero diagonal gates and Λ = log(expm1(-log(
    linspace(0.9, 0.999, w)) / 8)), so that a ≈ 0.9..0.999 at r = 1."""
    d, w = cfg.d_model, width(cfg)
    ramp = torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                          device=init.device)
    return {
        "in_proj": init.dense((d, 2 * w), d, dtype),
        "conv_w": init.normal((cfg.conv_width, w), 0.1, dtype),
        "conv_b": init.full((w,), 0.0, dtype),
        "w_a": init.full((w,), 0.0),
        "b_a": init.full((w,), 0.0),
        "w_x": init.full((w,), 0.0),
        "b_x": init.full((w,), 0.0),
        "lam": torch.log(torch.expm1(-torch.log(ramp) / _C)),
        "out_proj": init.dense((w, d), w, dtype),
    }


def _gates(params: dict, x: torch.Tensor):
    """a_t (recurrence gate) and the gated input, float32. x: (..., w)."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(params["w_a"] * xf + params["b_a"])
    i = torch.sigmoid(params["w_x"] * xf + params["b_x"])
    # jax.nn.softplus is logaddexp(x, 0); F.softplus is linear past 20
    softplus = torch.logaddexp(params["lam"], torch.zeros_like(params["lam"]))
    log_a = -_C * softplus * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xf)
    return a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    after the round of offset k, (a_t, b_t) is the combine of steps
    t-2k+1 .. t. Returns all h_t. Without a graph to record it overwrites
    ``a`` and ``b`` and returns ``b``; when autograd records (grad mode
    on, an input that requires grad) it runs the same rounds out of
    place, since a backward needs the operands each round saved. Both
    forms round alike, so their outputs are equal bit for bit."""
    length = a.shape[1]
    in_place = not layers.records_grad(a, b)
    k = 1
    while k < length:
        if in_place:
            b[:, k:] += a[:, k:] * b[:, :length - k]
        else:
            b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :length - k]],
                          dim=1)
        if 2 * k < length:
            if in_place:
                a[:, k:] = a[:, k:] * a[:, :length - k]
            else:
                a = torch.cat([a[:, :k], a[:, k:] * a[:, :length - k]],
                              dim=1)
        k *= 2
    return b


def _out(params: dict, h: torch.Tensor, gate: torch.Tensor,
         dtype) -> torch.Tensor:
    """out_proj(h ⊙ gelu(gate)), both factors cast to the model dtype."""
    y = h.to(dtype) * F.gelu(gate.to(torch.float32),
                             approximate="tanh").to(dtype)
    return layers.matmul(y, params["out_proj"])


def forward(params: dict, cfg: ArchConfig, u: torch.Tensor,
            state: dict | None = None, return_state: bool = False,
            kernels: str = "cuda"):
    """Full-sequence pass. u: (B, L, d). ``state`` ({"conv", "h"})
    resumes a sequence; ``return_state`` also returns the state after
    it. ``kernels`` is taken as ``ssm.forward`` takes it; no kernel
    runs on this path, so it changes nothing."""
    w = width(cfg)
    proj = layers.matmul(u, params["in_proj"])
    x, gate = proj[..., :w], proj[..., w:]
    x, conv_buf = ssm._causal_conv(params["conv_w"], params["conv_b"], x,
                                   None if state is None else state["conv"],
                                   silu=False)
    a, gx = _gates(params, x)                        # (B, L, w) float32
    if state is not None:
        first = gx[:, :1] + a[:, :1] * state["h"][:, None]
        if layers.records_grad(gx, a):
            gx = torch.cat([first, gx[:, 1:]], dim=1)
        else:
            gx[:, :1] = first
    h = linear_scan(a, gx)
    out = _out(params, h, gate, u.dtype)
    if return_state:
        return out, {"conv": conv_buf, "h": h[:, -1].clone()}
    return out


def init_state(cfg: ArchConfig, batch: int, dtype, device="cuda") -> dict:
    w = width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def decode_step(params: dict, cfg: ArchConfig, u: torch.Tensor,
                state: dict, kernels: str = "cuda"):
    """One-token step. u: (B, 1, d). Returns (out (B, 1, d), state), with
    ``state["conv"]`` and ``state["h"]`` updated in place. ``kernels`` is
    taken as the other mixers' and unused: the RG-LRU step has no
    kernel."""
    w = width(cfg)
    proj = layers.matmul(u, params["in_proj"])
    x, gate = proj[..., :w], proj[..., w:]
    buf = state["conv"]
    ext = torch.cat([buf.to(x.dtype), x], dim=1)     # (B, W, w)
    cw = params["conv_w"].shape[0]
    xc = torch.einsum("bwc,wc->bc", ext[:, ext.shape[1] - cw:]
                      .to(torch.float32),
                      params["conv_w"].to(torch.float32))
    xc = xc + params["conv_b"].to(torch.float32)     # Griffin: no conv act
    buf.copy_(ext[:, ext.shape[1] - (cw - 1):])
    a, gx = _gates(params, xc)                       # (B, w)
    h = state["h"]
    h.mul_(a).add_(gx)
    return _out(params, h[:, None, :], gate, u.dtype), state
