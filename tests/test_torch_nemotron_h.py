"""The port's Nemotron-H hybrid stack (NVIDIA-Nemotron-3-Nano-30B-A3B)
against the plain float32 reference ``tests/reference/nemotron_h.py``,
on the CPU.

A tiny seeded stack keeps the published pattern's whole period (52
layers: 23 Mamba-2, 23 expert, 6 attention) at toy widths, with 8
experts and top 2, in float32 under ``kernels="ref"``; the selection
bias is redrawn away from zero so that it moves the routing. The
expert kernel's parity with its plain version runs on the card only
(``cuda``); its tile plan is held here by a plain emulation of the
kernel's indexing. The new config fields' defaults are held to the
same configs with those fields spelled out, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from reference import nemotron_h as ref
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import REFERENCE_IDS
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels.ref import moe_gemm_ref
from repro_torch.models import layers, ssm
from repro_torch.models import model as tm
from repro_torch.models.transformer import layer_kinds
from repro_torch.serving import ServingEngine

CPU = dict(device="cpu", kernels="ref")
TOL = dict(atol=1e-4, rtol=1e-4)


def tiny(**kw):
    return dataclasses.replace(
        get_config("nemotron_3_nano"), d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab_size=97, n_experts=8, top_k=2, shared_d_ff=32,
        d_ff=48, ssm_heads=8, ssm_head_dim=16, ssm_state=8,
        ssm_groups=2, dtype="float32",
        name="nemotron-h-tiny", **kw)


def draw(cfg, seed: int = 0, bias: float = 0.3) -> dict:
    params = tm.init_params(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for layer in params["layers"]:
        if "moe" in layer:
            layer["moe"]["select_bias"].normal_(0.0, bias, generator=gen)
        if "mixer" in layer:
            layer["mixer"]["norm"]["scale"].normal_(0.0, 0.2, generator=gen)
            layer["mixer"]["dt_bias"].normal_(-2.0, 0.5, generator=gen)
    return params


@pytest.fixture(scope="module")
def stack():
    cfg = tiny()
    return cfg, draw(cfg)


def tokens(seed: int, b: int, s: int, vocab: int = 97) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, s)))


def test_the_tiny_stack_keeps_the_published_pattern(stack):
    cfg, params = stack
    kinds = layer_kinds(cfg)
    assert len(kinds) == 52 == len(params["layers"])
    assert kinds.count("hybrid_mamba") == kinds.count("hybrid_moe") == 23
    assert kinds.count("hybrid_attn") == 6
    assert all("mlp" not in p and "norm2" not in p for p in params["layers"])


def test_forward_matches_the_reference(stack):
    cfg, params = stack
    tok = tokens(1, 2, 19)
    got, aux = tm.forward(params, cfg, {"tokens": tok}, kernels="ref")
    want = ref.forward(params, cfg, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("b,slots", [(3, 3), (2, 4)],
                         ids=["b_eq_slots", "b_lt_slots"])
def test_generate_matches_the_reference_forward(stack, b, slots):
    """Prefill, then decode through the mixed cache (KV rings, conv and
    SSM states, nothing for the expert layers): every step's logits are
    the reference's full forward's at that position."""
    cfg, params = stack
    s, steps = 13, 6
    p = tokens(2 + b, b, s)
    eng = ServingEngine(cfg, params, slots=slots, max_len=24, **CPU)
    res = eng.generate(p, steps=steps)
    seq = torch.cat([p, torch.from_numpy(res.tokens[:, :-1]).long()], 1)
    want = ref.forward(params, cfg, seq)[:, s - 1:]
    np.testing.assert_array_equal(res.tokens, want.argmax(-1).numpy())
    caches = eng.cache["layers"]
    assert [set(c) for c in caches[:6]] == [
        {"conv", "ssm"}, set(), {"conv", "ssm"}, set(), {"conv", "ssm"},
        {"k", "v", "pos"}]


class TestRouter:
    def test_the_bias_chooses_but_does_not_weigh(self):
        gen = torch.Generator().manual_seed(3)
        router = torch.randn(16, 8, generator=gen)
        x = torch.randn(5, 16, generator=gen)
        bias = torch.zeros(8)
        idx0, w0, scores = layers.sigmoid_route(router, bias, x, 2, 2.5)
        bias[7] = 10.0
        idx1, w1, _ = layers.sigmoid_route(router, bias, x, 2, 2.5)
        assert (idx1[:, 0] == 7).all() and not (idx0[:, 0] == 7).all()
        chosen = scores.gather(1, idx1)
        np.testing.assert_allclose(
            w1.numpy(), (chosen / chosen.sum(-1, keepdim=True) * 2.5)
            .numpy(), rtol=1e-6)
        np.testing.assert_allclose(w1.sum(-1).numpy(), 2.5, rtol=1e-6)
        np.testing.assert_allclose(w0.sum(-1).numpy(), 2.5, rtol=1e-6)

    def test_ties_go_to_the_lower_expert(self):
        router = torch.zeros(4, 6)
        idx, w, _ = layers.sigmoid_route(router, torch.zeros(6),
                                         torch.ones(3, 4), 3, 1.0)
        assert idx.tolist() == [[0, 1, 2]] * 3
        np.testing.assert_allclose(w.numpy(), 1.0 / 3.0, rtol=1e-6)


def moe_params(cfg, seed: int = 4) -> dict:
    p = draw(cfg, seed)
    return p["layers"][1]["moe"]


def test_the_shared_expert_is_added_once_unscaled():
    cfg = tiny()
    p = moe_params(cfg)
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(5))
    both = layers.moe_dropless(p, x, top_k=2, kind="relu2",
                               routed_scale=2.5, kernels="ref")
    routed = layers.moe_dropless({k: v for k, v in p.items()
                                  if k != "shared"}, x, top_k=2,
                                 kind="relu2", routed_scale=2.5,
                                 kernels="ref")
    shared = ref.relu2_mlp(x, p["shared"]["wi"], p["shared"]["wo"])
    np.testing.assert_allclose((both - routed).numpy(), shared.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(both.numpy(),
                               ref.experts(p, cfg, x).numpy(), **TOL)


def test_no_token_is_dropped_when_all_route_to_one_expert():
    """A selection bias that sends every token to experts 3 and 5: each
    of 64 tokens gets both, where a capacity of 1.25 x T k / E rows
    would drop most."""
    cfg = tiny()
    p = moe_params(cfg)
    p["select_bias"] = torch.full((8,), -50.0)
    p["select_bias"][3] = p["select_bias"][5] = 50.0
    x = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(6))
    layers.MOE_RECORD = []
    try:
        got = layers.moe_dropless(p, x, top_k=2, kind="relu2",
                                  routed_scale=2.5, kernels="ref")
        rec = layers.MOE_RECORD[0]
    finally:
        layers.MOE_RECORD = None
    assert sorted(set(rec["gate_idx"].flatten().tolist())) == [3, 5]
    np.testing.assert_allclose(got.numpy(), ref.experts(p, cfg, x).numpy(),
                               **TOL)


def test_the_grouped_gate_first_norm_matches_the_reference():
    """The Mamba-2 mixer alone: in_proj, conv, the scan and
    rmsnorm(y * silu(z)) over 2 groups of the 128-wide inner width, and
    not over the whole width."""
    cfg = tiny()
    p = draw(cfg, 7)["layers"][0]["mixer"]
    u = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(8))
    got = ssm.forward(p, cfg, u, kernels="ref")
    np.testing.assert_allclose(got.numpy(), ref.mamba(p, cfg, u).numpy(),
                               **TOL)
    ungrouped = ref.mamba(p, cfg, u, norm_groups=1)
    assert not torch.allclose(ungrouped, got, atol=1e-3)


def spelled_out(cfg):
    """``cfg`` with the new fields set to what their defaults mean."""
    return dataclasses.replace(
        cfg, norm_eps=1e-6 if cfg.norm == "rmsnorm" else 1e-5,
        ssm_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        if "mamba2" in cfg.layer_pattern else 0)


@pytest.mark.parametrize("arch", [a for a in REFERENCE_IDS
                                  if a != "whisper_small"])
def test_new_defaults_leave_every_config_bit_identical(arch):
    cfg = reduced(get_config(arch))
    params = tm.init_params(cfg, seed=0, device="cpu")
    tok = tokens(9, 2, 12, cfg.vocab_size)
    a, _ = tm.forward(params, cfg, {"tokens": tok}, kernels="ref")
    b, _ = tm.forward(params, spelled_out(cfg), {"tokens": tok},
                      kernels="ref")
    assert torch.equal(a, b)


# ----------------------------------------------------------- the kernel
def emulate(a, rows, w, pl: mg.Plan, act: str) -> torch.Tensor:
    """``moe_gemm_kernel``'s indexing in plain Python: every block of
    the static grid, an early return past the plan's tiles, a tile's
    rows masked at its expert's end."""
    p = a.shape[0] if rows is None else rows.numel()
    out = torch.full((p, w.shape[2]), float("nan"))
    n_tiles = int(pl.n_tiles[0])
    for m in range(pl.max_tiles):
        if m >= n_tiles:
            continue
        e = int(pl.tile_expert[m])
        r = torch.arange(int(pl.tile_row0[m]),
                         int(pl.tile_row0[m]) + pl.block_m)
        r = r[r < int(pl.ends[e])]
        x = a[r] if rows is None else a[rows[r]]
        assert torch.isnan(out[r]).all(), "a row in two tiles"
        h = x @ w[e]
        out[r] = torch.relu(h).square() if act == "relu2" else h
    return out


@pytest.mark.parametrize("t,k,e,skew", [(32, 6, 16, False),
                                        (200, 6, 16, False),
                                        (40, 2, 8, True)],
                         ids=["decode", "prefill", "all_to_one"])
def test_the_tile_plan_covers_every_row_once(t, k, e, skew):
    gen = torch.Generator().manual_seed(t)
    scores = torch.rand(t, e, generator=gen)
    if skew:
        scores[:, :2] += 10.0
    idx = torch.sort(scores, dim=-1, descending=True).indices[:, :k]
    place, tok, counts = layers.sort_by_expert(idx, e)
    flat = idx.reshape(-1)
    assert torch.equal(tok[place], torch.arange(t * k) // k)
    assert torch.equal(counts, torch.bincount(flat, minlength=e).int())
    assert (torch.diff(flat[torch.argsort(place)]) >= 0).all()
    pl = mg.plan(counts, t * k)
    assert pl.max_tiles == -(-t * k // pl.block_m) + e
    a = torch.randn(t, 24, generator=gen)
    w = torch.randn(e, 24, 20, generator=gen)
    want = moe_gemm_ref(a, tok, w, counts, "relu2")
    got = emulate(a, tok, w, pl, "relu2")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: moe_gemm is a CUDA kernel")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,e,d,f,skew", [
    (32, 6, 128, 256, 192, False),      # the decode step's rows
    (700, 6, 128, 256, 192, False),     # a prefill's
    (64, 6, 16, 128, 96, True),         # every token on the same experts
])
def test_moe_gemm_matches_moe_gemm_ref(cuda_device, dtype, t, k, e, d, f,
                                       skew):
    gen = torch.Generator(cuda_device).manual_seed(t + e)
    scores = torch.rand(t, e, generator=gen, device=cuda_device)
    if skew:
        scores[:, :k] += 10.0
    idx = torch.sort(scores, dim=-1, descending=True).indices[:, :k]
    _, tok, counts = layers.sort_by_expert(idx, e)
    pl = mg.plan(counts, t * k)
    a = torch.randn(t, d, generator=gen, device=cuda_device).to(dtype)
    wi = (torch.randn(e, d, f, generator=gen, device=cuda_device)
          * d ** -0.5).to(dtype)
    wo = (torch.randn(e, f, d, generator=gen, device=cuda_device)
          * f ** -0.5).to(dtype)
    h = mg.moe_gemm(a, tok, wi, pl, act="relu2")
    out = mg.moe_gemm(h, None, wo, pl, out_dtype=torch.float32)
    torch.cuda.synchronize(cuda_device)
    want_h = moe_gemm_ref(a, tok, wi, counts, "relu2")
    want = moe_gemm_ref(want_h, None, wo, counts, out_dtype=torch.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h.float(), want_h.float(), **tol)
    torch.testing.assert_close(out, want, **tol)
