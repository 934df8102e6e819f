"""Shared transformer layer primitives of the port.

Plain functions on tensors, params as nested dicts of tensors, as in the
reference ``repro.models.layers``: init functions draw a dict, apply
functions take one. Weights keep the reference's layouts (``wq`` (d, H,
hd), ``wo`` (H, hd, d), MLP ``wi`` (d, d_ff)), so a reference pytree
carries across leaf for leaf (``repro_torch.convert``).

* Attention goes through ``repro_torch.kernels.ops``; ``kernels="cuda"``
  (the default) launches the hand-written kernels, ``kernels="ref"``
  runs their plain versions. ``"cuda"`` with CPU tensors raises.
* Matrix products run in the activation dtype through ``torch.matmul``
  and return that dtype, as the reference's
  ``preferred_element_type=float32`` followed by a cast. The CUDA GEMMs
  accumulate in float32 only under ``float32_gemms``, which the
  transformer's entry points enter: PyTorch's defaults let cuBLAS reduce
  bf16 products in bf16.
* Norms, RoPE and activations compute in float32 and cast back.
* ``self_attention_decode`` writes the new token into the cache tensors
  in place (the reference returns updated copies): a decode step then
  moves no cache bytes besides the one row per sequence.
* ``moe`` is the reference's top-k mixture of experts with its capacity
  drop, over ``sharding.moe_num_groups()`` token groups (1 unless the
  dry run's hooks set more). The router stays float32 in a bf16 model;
  the expert products are batched GEMMs over every expert's ``cap``
  rows, as the reference's einsums (no Pallas kernel backs them). Every
  shape follows from the input's: no host sync, no data-dependent size.
* ``moe_dropless`` is Nemotron-H's mixture (the reference has none): a
  float32 sigmoid router with a selection bias, no token dropped, the
  routed (token, expert) rows sorted by expert on the device and run by
  the grouped expert GEMM (``ops.moe_gemm``), a shared expert beside
  them. Its shapes follow from the input's alone too, so a CUDA graph
  captures it; it adds its routing counters (``expert_counters``) on
  the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels import moe_gemm, ops


class Init:
    """Draws weights: a seeded ``torch.Generator`` on ``device``. On the
    ``meta`` device it only shapes them (``model.param_count``).

    A weight is drawn in blocks of rows of at most ``DRAW_BLOCK``
    elements, each Normal(0, 1) in float32, scaled and cast into the
    result: a weight of up to ``DRAW_BLOCK`` elements is one draw, and a
    larger one never needs a float32 buffer of its full size beside it
    (a 256000 x 18432 head would need 18.9 GB)."""

    DRAW_BLOCK = 1 << 28

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)

    def dense(self, shape: tuple, fan_in: int, dtype) -> torch.Tensor:
        """Normal(0, 1/fan_in) in float32, cast to ``dtype``."""
        return self.normal(shape, fan_in ** -0.5, dtype)

    def normal(self, shape: tuple, std: float, dtype) -> torch.Tensor:
        """Normal(0, std^2) in float32, cast to ``dtype``."""
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        rows = max(1, self.DRAW_BLOCK // math.prod(shape[1:]))
        for i in range(0, shape[0], rows):
            block = out[i:i + rows]
            block.copy_(torch.randn(block.shape, generator=self.gen,
                                    dtype=torch.float32,
                                    device=self.device).mul_(std))
        return out

    def full(self, shape: tuple, value: float, dtype=torch.float32
             ) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


@contextlib.contextmanager
def float32_gemms():
    """The GEMM numerics the model assumes, for the duration: float32
    products without TF32, and bf16 products reduced in float32 (no
    reduced-precision split-K). The settings are process-wide; the
    caller's are put back on exit. Usable as a decorator."""
    cuda = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(),
             cuda.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("highest")
    cuda.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cuda.allow_bf16_reduced_precision_reduction = saved[1]


def records_grad(*trees) -> bool:
    """Whether autograd records an op on these inputs: grad mode is on
    and a tensor among them (nested dicts and lists searched too)
    requires grad."""
    def needs(tree) -> bool:
        if isinstance(tree, torch.Tensor):
            return tree.requires_grad
        if isinstance(tree, dict):
            tree = list(tree.values())
        return isinstance(tree, (list, tuple)) and any(map(needs, tree))
    return torch.is_grad_enabled() and needs(trees)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype (float32 accumulation in the GEMM under
    ``float32_gemms``)."""
    return torch.matmul(x, w)


# ------------------------------------------------------------------ norms
def rmsnorm_init(init: Init, d: int) -> dict:
    return {"scale": init.full((d,), 0.0)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])).to(x.dtype)


def layernorm_init(init: Init, d: int) -> dict:
    return {"scale": init.full((d,), 1.0), "bias": init.full((d,), 0.0)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return y.to(x.dtype)


def norm_init(init: Init, kind: str, d: int) -> dict:
    return rmsnorm_init(init, d) if kind == "rmsnorm" \
        else layernorm_init(init, d)


def apply_norm(kind: str, params: dict, x: torch.Tensor, eps: float = 0.0
               ) -> torch.Tensor:
    """The norm ``kind`` of x; ``eps`` 0 takes the norm's own epsilon."""
    if kind == "rmsnorm":
        return rmsnorm(params, x, eps or 1e-6)
    return layernorm(params, x, eps or 1e-5)


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    angles = angles[..., None, :]                            # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(length: int, d: int, device="cpu"
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings (length, d),
    float32: sines of the first d/2 columns, cosines of the rest."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1))
    pos = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)


# -------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0          # 0 = global
    softcap: float = 0.0
    causal: bool = True
    use_rope: bool = True
    qk_norm: bool = False    # chameleon-style query/key RMSNorm
    scale: Optional[float] = None


def attention_init(init: Init, spec: AttnSpec, dtype) -> dict:
    """Head-separated weights: wq (d, H, hd), wk / wv (d, Hkv, hd), wo
    (H, hd, d)."""
    d, h, hkv, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    p = {"wq": init.dense((d, h, hd), d, dtype),
         "wk": init.dense((d, hkv, hd), d, dtype),
         "wv": init.dense((d, hkv, hd), d, dtype),
         "wo": init.dense((h, hd, d), h * hd, dtype)}
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(init, hd)
        p["k_norm"] = rmsnorm_init(init, hd)
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, H, hd) -> (..., H, hd)."""
    y = sharding.reduce_partial(
        matmul(x, sharding.pin(w.reshape(w.shape[0], -1))))
    return sharding.unflattenable(y, w.shape[1:]).unflatten(-1, w.shape[1:])


def _proj_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) @ (H, hd, d) -> (..., d)."""
    return matmul(sharding.pin(x.flatten(-2)),
                  sharding.pin(w.reshape(-1, w.shape[-1])))


def _project_qkv(params: dict, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if spec.use_rope:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def self_attention(params: dict, spec: AttnSpec, x: torch.Tensor,
                   positions: torch.Tensor, kernels: str = "cuda"
                   ) -> torch.Tensor:
    """Training / prefill self-attention over a full sequence."""
    q, k, v = _project_qkv(params, spec, x, positions)
    out = _attend(spec, q, k, v, positions, kernels)
    return _proj_out(out, params["wo"])


def _attend(spec: AttnSpec, q, k, v, positions, kernels: str,
            causal: Optional[bool] = None, window: Optional[int] = None):
    """``ops.attention`` under ``spec`` (``causal`` / ``window`` when
    given), on each device's own rows and heads under DTensor."""
    causal = spec.causal if causal is None else causal
    window = spec.window if window is None else window

    def attend(q_, k_, v_, pos):
        return ops.attention(q_, k_, v_, causal=causal, window=window,
                             softcap=spec.softcap, scale=spec.scale,
                             segment_pos=pos, impl=kernels)
    return sharding.local_attention(
        attend, q, k, v, positions, mask_free=not causal and window == 0,
        softcap=spec.softcap, scale=spec.scale)


def self_attention_prefill(params: dict, spec: AttnSpec, x: torch.Tensor,
                           positions: torch.Tensor, cache_len: int,
                           kernels: str = "cuda"):
    """Prefill: full attention plus the KV cache, ring-buffered to
    ``cache_len`` slots (slot = position % cache_len, newest tokens win).

    ``positions`` are ascending and contiguous in every row, as every
    caller passes them, so the newest ``min(S, cache_len)`` tokens are
    the winners and land in distinct slots: only those are written. (A
    scatter of all S tokens has duplicate slots when S > cache_len, and
    a CUDA ``index_put_`` does not promise which duplicate write wins.)
    """
    q, k, v = _project_qkv(params, spec, x, positions)
    out = _attend(spec, q, k, v, positions, kernels)
    s = out.shape[1]
    y = _proj_out(out, params["wo"])
    n = min(s, cache_len)
    k_cache, v_cache, kv_pos = sharding.ring_fill(
        lambda kn, vn, newest: _ring_fill(kn, vn, newest, cache_len),
        k[:, s - n:], v[:, s - n:], positions[:, s - n:])
    return y, {"k": k_cache, "v": v_cache, "pos": kv_pos}


def _ring_fill(k: torch.Tensor, v: torch.Tensor, newest: torch.Tensor,
               cache_len: int):
    """Ring caches of ``cache_len`` slots holding the newest tokens' k, v
    (b, n, Hkv, hd) at slot = position % cache_len, the rest zeros with
    position -1."""
    b = k.shape[0]
    shape = (b, cache_len) + tuple(k.shape[2:])
    k_cache = torch.zeros(shape, dtype=k.dtype, device=k.device)
    v_cache = torch.zeros_like(k_cache)
    kv_pos = torch.full((b, cache_len), -1, dtype=torch.int32,
                        device=k.device)
    slots = (newest % cache_len).long()
    bidx = torch.arange(b, device=k.device)[:, None]
    k_cache[bidx, slots] = k
    v_cache[bidx, slots] = v
    kv_pos[bidx, slots] = newest.to(torch.int32)
    return k_cache, v_cache, kv_pos


def self_attention_decode(params: dict, spec: AttnSpec, x: torch.Tensor,
                          cache: dict, q_pos: torch.Tensor,
                          kernels: str = "cuda"):
    """One-token decode. x: (B, 1, d); q_pos: (B,) absolute positions.
    Writes the token's K/V and position into ``cache`` in place and
    returns (y (B, 1, d), cache)."""
    q, k, v = _project_qkv(params, spec, x, q_pos[:, None])
    cache_len = cache["k"].shape[1]
    slot = (q_pos % cache_len).long()                          # (B,)
    sharding.ring_write(cache["k"], slot, k[:, 0])
    sharding.ring_write(cache["v"], slot, v[:, 0])
    sharding.ring_write(cache["pos"], slot, q_pos.to(torch.int32))
    out = sharding.local_decode_attention(
        lambda *a: ops.decode_attention(
            *a, window=spec.window, softcap=spec.softcap, scale=spec.scale,
            impl=kernels),
        q[:, 0], cache["k"], cache["v"], cache["pos"], q_pos.to(torch.int32),
        window=spec.window, softcap=spec.softcap, scale=spec.scale)
    return _proj_out(out, params["wo"])[:, None, :], cache


def cross_attention_init(init: Init, spec: AttnSpec, dtype) -> dict:
    return attention_init(init, spec, dtype)


def cross_attention(params: dict, spec: AttnSpec, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    kernels: str = "cuda") -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V: no causal
    mask and no window, so no mask depends on a position. The query
    positions are the reference's, every one at ``enc_len - 1``."""
    b, s, _ = x.shape
    q = _proj_heads(x, params["wq"])
    pos = torch.full((b, s), enc_k.shape[1] - 1, dtype=torch.int32,
                     device=x.device)
    out = _attend(spec, q, enc_k, enc_v, pos, kernels, causal=False,
                  window=0)
    return _proj_out(out, params["wo"])


def cross_kv(params: dict, spec: AttnSpec, enc_out: torch.Tensor):
    """The encoder states' keys and values, (B, S_enc, Hkv, hd) each."""
    return _proj_heads(enc_out, params["wk"]), \
        _proj_heads(enc_out, params["wv"])


# ------------------------------------------------------------------- MLPs
MLP_KINDS = ("swiglu", "geglu", "relu2", "gelu")


def mlp_init(init: Init, d: int, d_ff: int, kind: str, dtype) -> dict:
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp kind {kind}")
    p = {"wi": init.dense((d, d_ff), d, dtype)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = init.dense((d, d_ff), d, dtype)
    p["wo"] = init.dense((d_ff, d), d_ff, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = matmul(x, params["wi"])
    if kind == "swiglu":
        h = F.silu(matmul(x, params["wg"]).to(torch.float32)).to(x.dtype) * h
    elif kind == "geglu":
        h = F.gelu(matmul(x, params["wg"]).to(torch.float32),
                   approximate="tanh").to(x.dtype) * h
    elif kind == "relu2":
        h = F.relu(h.to(torch.float32)).square().to(x.dtype)
    elif kind == "gelu":
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return matmul(h, params["wo"])


# -------------------------------------------------------------------- MoE
#: when a list, every ``moe`` call appends its routing record: "gate_idx",
#: "keep" and "slot" (T, k) per token and choice, in the router's order;
#: "top" (T, min(k + 1, E)), each token's largest probabilities in
#: descending order; "cap". None (the default) records nothing.
MOE_RECORD: Optional[list] = None


def moe_init(init: Init, d: int, d_ff: int, n_experts: int, kind: str,
             dtype, select_bias: bool = False, shared_d_ff: int = 0) -> dict:
    """Router (d, E) in float32 whatever ``dtype``; experts ``wi``, ``wg``
    (gated kinds) (E, d, d_ff) and ``wo`` (E, d_ff, d) in ``dtype``.
    ``select_bias`` adds the dropless sigmoid router's selection bias
    ``select_bias`` (E,) in float32 (zeros); ``shared_d_ff`` > 0 a shared
    expert ``shared``, an MLP of that width."""
    p = {"router": init.dense((d, n_experts), d, torch.float32),
         "wi": init.dense((n_experts, d, d_ff), d, dtype)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = init.dense((n_experts, d, d_ff), d, dtype)
    p["wo"] = init.dense((n_experts, d_ff, d), d_ff, dtype)
    if select_bias:
        p["select_bias"] = init.full((n_experts,), 0.0)
    if shared_d_ff:
        p["shared"] = mlp_init(init, d, shared_d_ff, kind, dtype)
    return p


def moe_capacity(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Rows per expert: the reference's expression, Python's
    round-half-even included (8 tokens, top-4 of 16 experts: cap 2)."""
    return int(max(1, round(tokens * top_k / n_experts * capacity_factor)))


def _bmm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) with a float32 result, products accumulated
    in float32 (the reference's einsum with ``preferred_element_type``
    and no cast). bf16 x bf16 products are exact in float32: on the card
    one batched GEMM with a float32 output; on the CPU (no such kernel
    there) each expert's operands upcast in turn, never all experts at
    once."""
    if a.dtype == torch.float32:
        return torch.bmm(a, w)
    if a.device.type == "cuda":
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.stack([a[i].float() @ w[i].float()
                        for i in range(a.shape[0])])


def _route(probs: torch.Tensor, top_k: int, cap: int):
    """One group's routing per token (the group's tokens on dim 1):
    gate_idx, gates (normalised), keep, slot (G, Tg, k) and the chosen
    one-hots (G, Tg, E). A token's rank within an expert is the number of
    earlier tokens of its group that chose it."""
    e = probs.shape[-1]
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = order[..., :top_k]
    gates = ranked[..., :top_k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    chosen = torch.zeros(probs.shape, dtype=torch.float32,
                         device=probs.device) \
        .scatter_(2, gate_idx, 1.0)                     # k ones per token
    hits = chosen.to(torch.int64)
    rank = (torch.cumsum(hits, dim=1) - hits).gather(2, gate_idx)
    keep = rank < cap
    slot = gate_idx * cap + torch.clamp_max(rank, cap - 1)
    return gate_idx, gates, keep, slot, chosen, ranked[..., :top_k + 1]


def _dispatch(xf: torch.Tensor, keep: torch.Tensor, slot: torch.Tensor,
              e: int, cap: int) -> torch.Tensor:
    """(G, Tg, d) tokens -> (G, E, cap, d) expert buffer. Kept (expert,
    rank) slots are distinct; a dropped choice adds zeros into its
    group's last slot, which leaves it unchanged."""
    g, tg, d = xf.shape
    src = torch.where(keep[..., None], xf[:, :, None, :],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    base = (torch.arange(g, device=xf.device) * (e * cap))[:, None, None]
    idx = torch.where(keep, slot, e * cap - 1) + base
    return torch.zeros((g * e * cap, d), dtype=xf.dtype, device=xf.device) \
        .index_add_(0, idx.reshape(-1), src.reshape(-1, d)) \
        .view(g, e, cap, d)


def _combine(out: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
             keep: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
    """(G, E, cap, d) expert outputs -> (G, Tg, d): each token gathers its
    k gated rows and adds them in ascending expert order (no float
    atomics: a fixed order of adds)."""
    g, e, cap, d = out.shape
    top_k = slot.shape[-1]
    rows = out.reshape(g, e * cap, d)
    part = rows.gather(1, slot.reshape(g, -1, 1).expand(-1, -1, d)) \
        .view(slot.shape + (d,)) * (gates * keep).to(out.dtype)[..., None]
    part = part.gather(2, torch.argsort(gate_idx, dim=2)[..., None]
                       .expand(-1, -1, -1, d))
    y = part[:, :, 0]
    for j in range(1, top_k):
        y = y + part[:, :, j]
    return y


def _expert_bmm(buf: torch.Tensor, w: torch.Tensor, f32: bool = False
                ) -> torch.Tensor:
    """(G, E, C, d) @ (E, d, f) -> (G, E, C, f): one batched GEMM over
    experts of every group's rows (``_bmm_f32`` for a float32 result)."""
    g, e, c, d = buf.shape
    a = buf.transpose(0, 1).reshape(e, g * c, d)
    h = _bmm_f32(a, w) if f32 else torch.bmm(a, w)
    return h.view(e, g, c, h.shape[-1]).transpose(0, 1)


def moe(params: dict, x: torch.Tensor, *, top_k: int, kind: str,
        capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k mixture of experts with the reference's capacity drop.

    x: (B, S, d). Returns (output in x's dtype, the Switch load-balance
    aux loss, float32). Tokens are split into
    ``sharding.moe_num_groups()`` groups (1 unless the dry run's hooks
    set more; 1 when it does not divide the tokens), each with its own
    ``cap`` rows per expert, as the reference's data-local dispatch. The
    router's float32 softmax picks each token's k experts in order of
    probability (ties to the lower index, as ``lax.top_k``), gates
    normalised by max(sum, 1e-9). A token's rank within an expert is the
    number of earlier tokens of its group that chose it (the reference's
    stable sort); ranks from ``cap`` up are dropped. Each expert runs
    its ``cap`` rows, empty or not; a token sums its gated outputs in
    ascending expert order, the reference's scatter order. The routing,
    dispatch and combine run per device on its own groups under DTensor
    (``sharding.local_groups``); the three ``constrain_moe_*`` hooks sit
    at the reference's places.
    """
    b, s, d = x.shape
    t = b * s
    e = params["router"].shape[1]
    groups = sharding.moe_num_groups()
    if t % groups:
        groups = 1
    tg = t // groups
    xf = sharding.constrain_moe_groups(x.reshape(groups, tg, d))
    probs = torch.softmax(torch.matmul(xf.to(torch.float32),
                                       params["router"]), dim=-1)
    cap = moe_capacity(tg, top_k, e, capacity_factor)
    gate_idx, gates, keep, slot, chosen, top = sharding.local_groups(
        lambda p: _route(p, top_k, cap), probs)
    aux = e * torch.sum(probs.reshape(t, e).mean(dim=0)
                        * chosen.reshape(t, e).mean(dim=0))
    if MOE_RECORD is not None:
        MOE_RECORD.append({"gate_idx": gate_idx.reshape(t, top_k),
                           "keep": keep.reshape(t, top_k),
                           "slot": slot.reshape(t, top_k),
                           "top": top.reshape(t, -1), "cap": cap})

    buf = sharding.local_groups(
        lambda xg, kg, sg: _dispatch(xg, kg, sg, e, cap), xf, keep, slot)
    buf = sharding.constrain_moe_buffer(buf)     # (G, E, C, d)
    weight = sharding.constrain_moe_weight
    h = _expert_bmm(buf, weight(params["wi"]))
    if kind == "swiglu":
        h = (F.silu(_expert_bmm(buf, weight(params["wg"]), f32=True))
             * h.to(torch.float32)).to(x.dtype)
    elif kind == "geglu":
        h = (F.gelu(_expert_bmm(buf, weight(params["wg"]), f32=True),
                    approximate="tanh") * h.to(torch.float32)).to(x.dtype)
    elif kind == "relu2":
        h = F.relu(h.to(torch.float32)).square().to(x.dtype)
    elif kind == "gelu":
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    out = sharding.constrain_moe_buffer(
        _expert_bmm(h, weight(params["wo"])))
    y = sharding.local_groups(_combine, out, slot, gates, keep, gate_idx)
    y = sharding.constrain_moe_groups(y)
    return y.reshape(b, s, d), aux


# ------------------------------------------------------- dropless experts
#: the routing counters' columns, per phase (row 0 prefill, row 1 decode):
#: MoE launches, and rows routed, experts touched and the most rows on
#: one expert summed over them
EXPERT_COLUMNS = ("launches", "rows", "touched", "max_rows")
EXPERT_PHASES = ("prefill", "decode")
#: launches the per-launch log holds, the newest last
EXPERT_LOG = 1 << 16
#: device -> its ``ExpertCounters`` (``expert_counters``)
EXPERT_COUNTERS: dict = {}


@dataclasses.dataclass
class ExpertCounters:
    """The routing of ``moe_dropless``'s launches on one device, kept on
    the device: ``phase`` (2, 4) int64 sums by phase (``EXPERT_COLUMNS``)
    and ``log`` (``EXPERT_LOG``, 2) int32, the rows and the experts
    touched of each launch, launch ``i`` at row ``i % EXPERT_LOG``, with
    ``at`` (1,) int64 the launches logged."""

    phase: torch.Tensor
    log: torch.Tensor
    at: torch.Tensor


def expert_counters(device) -> ExpertCounters:
    """The routing counters of ``moe_dropless`` on ``device``, made at
    their first use: every launch adds to them in place on the device,
    in a captured decode step too, so reading them is the only sync."""
    key = str(torch.device(device))
    if key not in EXPERT_COUNTERS:
        EXPERT_COUNTERS[key] = ExpertCounters(
            phase=torch.zeros((len(EXPERT_PHASES), len(EXPERT_COLUMNS)),
                              dtype=torch.int64, device=device),
            log=torch.zeros((EXPERT_LOG, 2), dtype=torch.int32,
                            device=device),
            at=torch.zeros(1, dtype=torch.int64, device=device))
    return EXPERT_COUNTERS[key]


def _count_experts(c: ExpertCounters, phase: int,
                   counts: torch.Tensor) -> None:
    """Add one launch's routing (``counts``: rows per expert) to the
    counters, on the device."""
    vals = torch.stack([counts.sum(), (counts > 0).sum(), counts.max()]) \
        .to(torch.int64)                         # rows, touched, max rows
    c.phase[phase, 0].add_(1)
    c.phase[phase, 1:].add_(vals)
    c.log.index_copy_(0, c.at % c.log.shape[0],
                      vals[None, :2].to(torch.int32))
    c.at.add_(1)


def sigmoid_route(router: torch.Tensor, select_bias: torch.Tensor,
                  x: torch.Tensor, top_k: int, scale: float):
    """Nemotron-H's router on tokens x (T, d): float32 sigmoid scores,
    each token's ``top_k`` experts by score + ``select_bias`` (ties to
    the lower index), their scores divided by the chosen scores' sum
    (+ 1e-20) and multiplied by ``scale``. The bias chooses; it never
    weighs. Returns (expert ids (T, k) in order of choice, float32
    weights (T, k), scores (T, E))."""
    scores = torch.sigmoid(torch.matmul(x.to(torch.float32), router))
    order = torch.sort(scores + select_bias, dim=-1, descending=True,
                       stable=True).indices
    idx = order[:, :top_k]
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale
    return idx, w, scores


def sort_by_expert(idx: torch.Tensor, n_experts: int):
    """The (token, expert) pairs of ``idx`` (T, k), flattened token by
    token, sorted by expert (a stable sort: within an expert, in token
    order) on the device without a sync: (each pair's place in the
    sorted order (T*k,), the token of each sorted row (T*k,), rows per
    expert (E,) int32, an exact integer histogram)."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    place = torch.empty_like(order).scatter_(
        0, order, torch.arange(flat.numel(), device=idx.device))
    counts = torch.zeros(n_experts, dtype=torch.int32, device=idx.device) \
        .scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return place, order // idx.shape[1], counts


def moe_dropless(params: dict, x: torch.Tensor, *, top_k: int, kind: str,
                 routed_scale: float, kernels: str = "cuda",
                 counters: Optional[tuple] = None) -> torch.Tensor:
    """Nemotron-H's mixture of experts, dropping no token. x: (B, S, d).

    ``sigmoid_route`` picks each token's k experts; the routed rows,
    sorted by expert (``sort_by_expert``), go through the grouped expert
    GEMM (``ops.moe_gemm``) twice: up with the activation (relu² fused
    into the kernel) in x's dtype, down with a float32 result. A token
    adds its k weighted rows in float32 in ascending expert order (a
    fixed order of adds, so a run repeats bit for bit), then the shared
    expert's output, unscaled, and the sum is cast to x's dtype. Every
    shape follows from x's: no sync, no data-dependent size. With
    ``counters`` (``expert_counters`` and a phase, 0 prefill or 1 decode)
    the launch's routing is added to them; ``MOE_RECORD`` collects
    "gate_idx", "weights" and "scores"."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e = params["router"].shape[1]
    idx, w, scores = sigmoid_route(params["router"], params["select_bias"],
                                   xf, top_k, routed_scale)
    if MOE_RECORD is not None:
        MOE_RECORD.append({"gate_idx": idx, "weights": w, "scores": scores})
    place, tokens, counts = sort_by_expert(idx, e)
    if counters is not None:
        _count_experts(*counters, counts)
    plan = moe_gemm.plan(counts, t * top_k)
    h = ops.moe_gemm(xf, tokens, params["wi"], plan, act=kind,
                     impl=kernels)
    out = ops.moe_gemm(h, None, params["wo"], plan, act="none",
                       out_dtype=torch.float32, impl=kernels)
    asc = torch.argsort(idx, dim=1)
    rows = place.view(t, top_k).gather(1, asc)
    wt = w.gather(1, asc)
    y = out[rows[:, 0]] * wt[:, :1]
    for j in range(1, top_k):
        y = y + out[rows[:, j]] * wt[:, j:j + 1]
    if "shared" in params:
        y = y + mlp(params["shared"], xf, kind).to(torch.float32)
    return y.to(x.dtype).reshape(b, s, d)
