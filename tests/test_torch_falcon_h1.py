"""Falcon-H1 (Falcon-H1-34B-Instruct's ``"parallel_hybrid"`` layers) on
the CPU: the plain reference ``tests/reference/falcon_h1.py`` against
``transformers``' ``FalconH1ForCausalLM``, the conversion
``convert.falcon_h1_params`` leaf by leaf, the port on the converted
weights against the reference, and the benchmark's reference of the
layer kind (``laimr_bench/reference/parallel_hybrid.py``, on the folded
tree) against the same.

A tiny stack keeps every mechanism at toy widths (2 layers, d 64, 4
query and 2 key / value heads of 16, 4 SSM heads of 16 over 2 groups,
state 8), in float32, with the published multipliers and an attention
input multiplier of 0.7 (the published 1.0 would leave that fold
unchecked), and rotary at theta 1e4 (at the published 1e11 a 16-wide
head's angles stay near 0 over a short prompt). Weights are drawn away
from their init (norm weights, dt bias, D, conv bias) so that each leaf
moves the output, and the projections that a multiplier shrinks (k, the
mixer's in and out, the MLP's gate and down, the head) drawn larger by
about its inverse, so that each sublayer weighs in. Tolerances:
float32 sums in another order through two layers of products, the SSD
summed sequentially against ``transformers``' chunked form: 1e-4 of a
logit, absolute and relative.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reference import falcon_h1 as ref
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.falcon_h1_34b import MULTIPLIERS
from repro_torch.models import model as tm
from repro_torch.models.transformer import init_cache, layer_kinds
from repro_torch.serving import ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = dict(device="cpu", kernels="ref")
MU = dict(MULTIPLIERS, attention_in_multiplier=0.7)
ROOT = Path(__file__).resolve().parents[1]


def tiny():
    return dataclasses.replace(
        get_config("falcon_h1_34b"), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=48, vocab_size=97, ssm_heads=4,
        ssm_head_dim=16, ssm_state=8, ssm_groups=2, rope_theta=1e4,
        dtype="float32", name="falcon-h1-tiny")


def state_dict(cfg, seed: int = 0) -> dict:
    """A ``FalconH1ForCausalLM`` state dict of ``cfg``'s widths under the
    published names, drawn from ``seed``: projections Normal(0,
    1/fan_in), norm weights 1 + Normal(0, 0.2), conv taps Normal(0,
    0.25), its bias, dt_bias and D Normal(0, 0.5), A_log log U(1, 8);
    the projections that a multiplier shrinks times about its inverse."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    sh, sp, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    d_in, conv = sh * sp, sh * sp + 2 * g * n
    proj = 2 * d_in + 2 * g * n + sh
    sd = {"model.embed_tokens.weight": normal(cfg.vocab_size, d),
          "model.final_layernorm.weight": normal(d, std=0.2, mean=1.0),
          "lm_head.weight": normal(cfg.vocab_size, d, std=d ** -0.5) * 128}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": normal(d, std=0.2, mean=1.0),
            pre + "pre_ff_layernorm.weight": normal(d, std=0.2, mean=1.0),
            pre + "self_attn.q_proj.weight": normal(h * hd, d, std=d ** -0.5),
            pre + "self_attn.k_proj.weight": normal(hkv * hd, d,
                                                    std=d ** -0.5) * 30,
            pre + "self_attn.v_proj.weight": normal(hkv * hd, d,
                                                    std=d ** -0.5),
            pre + "self_attn.o_proj.weight": normal(d, h * hd,
                                                    std=(h * hd) ** -0.5),
            pre + "mamba.in_proj.weight": normal(proj, d, std=d ** -0.5) * 3,
            pre + "mamba.conv1d.weight": normal(conv, 1, cfg.conv_width,
                                                std=0.25),
            pre + "mamba.conv1d.bias": normal(conv, std=0.5),
            pre + "mamba.dt_bias": normal(sh, std=0.5),
            pre + "mamba.A_log": torch.log(torch.empty(sh).uniform_(
                1.0, 8.0, generator=gen)),
            pre + "mamba.D": normal(sh, std=0.5, mean=1.0),
            pre + "mamba.norm.weight": normal(d_in, std=0.2, mean=1.0),
            pre + "mamba.out_proj.weight": normal(d, d_in, std=d_in ** -0.5)
            * 10,
            pre + "feed_forward.gate_proj.weight": normal(f, d, std=d ** -0.5)
            * 5,
            pre + "feed_forward.up_proj.weight": normal(f, d, std=d ** -0.5),
            pre + "feed_forward.down_proj.weight": normal(d, f,
                                                          std=f ** -0.5) * 30,
        })
    return sd


@pytest.fixture(scope="module")
def stack():
    cfg = tiny()
    sd = state_dict(cfg)
    return cfg, sd, convert.falcon_h1_params(sd, cfg, MU)


def tokens(seed: int, b: int, s: int, vocab: int = 97) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, s)))


def hf_model(cfg, sd: dict):
    """``transformers``' ``FalconH1ForCausalLM`` of ``cfg`` holding
    ``sd``, or a skip where the package does not import."""
    try:
        from transformers import FalconH1Config, FalconH1ForCausalLM
    except ImportError as e:
        pytest.skip(f"transformers' FalconH1 does not import: {e}")
    hc = FalconH1Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        mamba_d_ssm=cfg.ssm_heads * cfg.ssm_head_dim,
        mamba_n_heads=cfg.ssm_heads, mamba_d_head=cfg.ssm_head_dim,
        mamba_n_groups=cfg.ssm_groups, mamba_d_state=cfg.ssm_state,
        mamba_d_conv=cfg.conv_width, mamba_chunk_size=8,
        mamba_conv_bias=True, mamba_proj_bias=False,
        mamba_norm_before_gate=False, mamba_rms_norm=True,
        projectors_bias=False, tie_word_embeddings=False,
        max_position_embeddings=128,
        **{k: list(v) if isinstance(v, tuple) else v
           for k, v in MU.items()})
    hc._attn_implementation = "eager"
    torch.manual_seed(0)
    m = FalconH1ForCausalLM(hc).float().eval()
    missing, unexpected = m.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    return m


def test_the_reference_is_transformers_falcon_h1(stack):
    cfg, sd, _ = stack
    m = hf_model(cfg, sd)
    tok = tokens(1, 2, 21)
    with torch.no_grad():
        want = m(input_ids=tok, use_cache=False).logits
    got = ref.forward(sd, cfg, MU, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_every_multiplier_is_folded_leaf_by_leaf(stack):
    cfg, sd, p = stack
    gm, dm = MU["mlp_multipliers"]
    mup = ref.mup_vector(cfg, MU) * MU["ssm_in_multiplier"]
    torch.testing.assert_close(
        p["embed"], sd["model.embed_tokens.weight"]
        * MU["embedding_multiplier"], rtol=0, atol=0)
    torch.testing.assert_close(p["lm_head"], sd["lm_head.weight"].T
                               * MU["lm_head_multiplier"], rtol=0, atol=0)
    torch.testing.assert_close(
        p["final_norm"]["scale"] + 1, sd["model.final_layernorm.weight"])
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for i, layer in enumerate(p["layers"]):
        pre = f"model.layers.{i}."
        at, mb, ff = pre + "self_attn.", pre + "mamba.", pre + "feed_forward."
        want = {
            ("attn", "wq"): (sd[at + "q_proj.weight"].T
                             * MU["attention_in_multiplier"])
            .reshape(d, h, hd),
            ("attn", "wk"): (sd[at + "k_proj.weight"].T
                             * (MU["attention_in_multiplier"]
                                * MU["key_multiplier"])).reshape(d, hkv, hd),
            ("attn", "wv"): (sd[at + "v_proj.weight"].T
                             * MU["attention_in_multiplier"])
            .reshape(d, hkv, hd),
            ("attn", "wo"): (sd[at + "o_proj.weight"].T
                             * MU["attention_out_multiplier"])
            .reshape(h, hd, d),
            ("mixer", "in_proj"): sd[mb + "in_proj.weight"].T * mup,
            ("mixer", "conv_w"): sd[mb + "conv1d.weight"][:, 0].T,
            ("mixer", "conv_b"): sd[mb + "conv1d.bias"],
            ("mixer", "dt_bias"): sd[mb + "dt_bias"],
            ("mixer", "a_log"): sd[mb + "A_log"],
            ("mixer", "d_skip"): sd[mb + "D"],
            ("mixer", "out_proj"): sd[mb + "out_proj.weight"].T
            * MU["ssm_out_multiplier"],
            ("mlp", "wg"): sd[ff + "gate_proj.weight"].T * gm,
            ("mlp", "wi"): sd[ff + "up_proj.weight"].T,
            ("mlp", "wo"): sd[ff + "down_proj.weight"].T * dm}
        for (a, b), w in want.items():
            torch.testing.assert_close(layer[a][b], w, rtol=0, atol=0)
            assert layer[a][b].is_contiguous()
        for key, name in (("norm1", "input_layernorm"),
                          ("norm2", "pre_ff_layernorm")):
            torch.testing.assert_close(layer[key]["scale"] + 1,
                                       sd[pre + name + ".weight"])
        torch.testing.assert_close(layer["mixer"]["norm"]["scale"] + 1,
                                   sd[mb + "norm.weight"])


def test_the_conversion_refuses_a_wrong_state_dict(stack):
    cfg, sd, _ = stack
    with pytest.raises(ValueError, match="no 'layers.1.mamba.D'"):
        convert.falcon_h1_params(
            {k: v for k, v in sd.items() if not k.endswith("1.mamba.D")},
            cfg, MU)
    with pytest.raises(ValueError, match="unexpected"):
        convert.falcon_h1_params(dict(sd, extra=torch.zeros(1)), cfg, MU)
    with pytest.raises(ValueError, match="shape"):
        convert.falcon_h1_params(dict(sd, **{
            "model.layers.0.mamba.D": torch.zeros(3)}), cfg, MU)


def test_the_published_multipliers_are_the_default(stack):
    cfg, sd, _ = stack
    a = convert.falcon_h1_params(sd, cfg)
    b = convert.falcon_h1_params(sd, cfg, MULTIPLIERS)
    assert all(torch.equal(x, y) for x, y in zip(
        a["layers"][0]["attn"].values(), b["layers"][0]["attn"].values()))


def test_forward_matches_the_reference(stack):
    cfg, sd, p = stack
    tok = tokens(2, 2, 19)
    got, aux = tm.forward(p, cfg, {"tokens": tok}, kernels="ref")
    want = ref.forward(sd, cfg, MU, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_the_reference_forward(stack):
    """The last-token logits of a prefill and of every decode step
    through the cache (ring, conv buffer and state of each layer) are
    the reference's full forward's at that position."""
    cfg, sd, p = stack
    b, s, steps = 2, 11, 5
    seq = tokens(3, b, s + steps)
    want = ref.forward(sd, cfg, MU, seq)
    logits, cache = tm.prefill(p, cfg, {"tokens": seq[:, :s]}, max_len=24,
                               kernels="ref")
    np.testing.assert_allclose(logits.numpy(), want[:, s - 1].numpy(),
                               **TOL)
    assert [set(c) for c in cache["layers"]] == \
        [{"k", "v", "pos", "conv", "ssm"}] * cfg.n_layers
    for t in range(steps):
        pos = torch.full((b,), s + t, dtype=torch.int32)
        logits, cache = tm.decode_step(p, cfg, seq[:, s + t].int(), cache,
                                       pos, kernels="ref")
        np.testing.assert_allclose(logits.numpy(), want[:, s + t].numpy(),
                                   **TOL)


@pytest.mark.parametrize("b,slots", [(3, 3), (2, 4)],
                         ids=["b_eq_slots", "b_lt_slots"])
def test_generate_matches_the_reference_forward(stack, b, slots):
    """``ServingEngine.generate`` (prefill, then greedy decode through
    the engine's cache: adopted at B == slots, merged at B < slots):
    every served token is the reference full forward's argmax at its
    position, none within 1e-3 of a tie."""
    cfg, sd, p = stack
    s, steps = 13, 6
    prompt = tokens(4 + b, b, s)
    eng = ServingEngine(cfg, p, slots=slots, max_len=24, **CPU)
    res = eng.generate(prompt, steps=steps)
    seq = torch.cat([prompt, torch.from_numpy(res.tokens[:, :-1]).long()],
                    1)
    want = ref.forward(sd, cfg, MU, seq)[:, s - 1:]
    top2 = want.topk(2, dim=-1).values
    assert bool((top2[..., 0] - top2[..., 1] > 1e-3).all())
    np.testing.assert_array_equal(res.tokens, want.argmax(-1).numpy())
    assert all(set(c) == {"k", "v", "pos", "conv", "ssm"}
               for c in eng.cache["layers"])


def test_the_cache_holds_both_kinds_of_state():
    cfg = tiny()
    cache = init_cache(cfg, 3, 24, device="cpu")["layers"]
    assert layer_kinds(cfg) == ["parallel_hybrid"] * cfg.n_layers
    for c in cache:
        assert c["k"].shape == (3, 24, cfg.n_kv_heads, cfg.head_dim)
        assert c["ssm"].shape == (3, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)
        assert c["ssm"].dtype == torch.float32
        assert c["conv"].shape == (3, cfg.conv_width - 1, 64 + 2 * 2 * 8)
        assert bool((c["pos"] == -1).all())


def test_the_published_config():
    cfg = get_config("falcon_h1_34b")
    assert tm.param_count(cfg) == 33_642_516_224
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (72, 5120, 20, 4, 128, 21504, 261120)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_groups, cfg.conv_width) == (32, 128, 256, 2, 4)
    assert cfg.rope_theta == 1e11 and cfg.ssm_gate_first
    small = reduced(cfg)
    assert small.ssm_heads <= 8 and small.ssm_state <= 16 \
        and small.ssm_head_dim <= 32 and small.n_layers == 2


def bench_module(name: str):
    """``laimr_bench/reference/<name>.py`` as a module (the benchmark's
    package on the path)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"laimr_bench.reference.{name}",
        ROOT / "laimr_bench" / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_benchmarks_reference_on_the_folded_tree(stack):
    """The benchmark's plain layer (``reference/parallel_hybrid.py``)
    over the folded tree, with the embedding, norm and head of its
    ``model_ref``, against this reference on the unfolded weights; the
    sequence is a multiple of its ``CHUNK``."""
    cfg, sd, p = stack
    layer = bench_module("parallel_hybrid")
    model_ref = bench_module("model_ref")
    dims = {**vars(cfg), "partial_rotary_factor": 1.0}
    layer.check(dims)
    tok = tokens(5, 2, layer.CHUNK)
    with torch.no_grad():
        x = p["embed"][tok].float()
        for lp in p["layers"]:
            x = layer.layer(lp, dims, x)
        got = model_ref.head(p, dims, x)
    want = ref.forward(sd, cfg, MU, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
