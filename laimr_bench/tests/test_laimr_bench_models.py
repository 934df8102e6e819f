"""The plain references compute what the port's plain path computes, at
reduced widths in float32, and the fp8 control departs from them."""
import pytest
import torch

from laimr_bench import replica
from laimr_bench.reference import mamba2, model_ref
from laimr_bench.tests import tiny
from repro_torch.models import model
from repro_torch.serving.engine import ServingEngine

ARCHS = ("stablelm_3b", "mamba2_370m")


def setup(arch, seed=2**31 + 3):
    conf = tiny.conf(arch)
    cfg = replica.arch_config(conf)
    params = replica.make_params(conf["layer_kind"], cfg, seed, "cpu")
    return conf, cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_forward_equals_the_port(arch):
    conf, cfg, params = setup(arch)
    tokens = replica.prompts(5, 3, 70, cfg.vocab_size, "cpu")
    want, _ = model.forward(params, cfg, {"tokens": tokens}, kernels="ref")
    got = model_ref.logits(conf, params, tokens, 0)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_are_the_references_best(arch):
    """Prefill, then decoding through the cache (a full wave and a
    partial one), gives tokens whose reference logit is the best. A full
    wave of a global-attention model adopts the prefill cache as a ring
    as deep as the prompt, and its decode steps overwrite the prompt's
    oldest keys: only its first token is held here (the benchmark's
    StableLM-3B cell decodes none)."""
    conf, cfg, params = setup(arch)
    for b in (4, 2):
        steps = 1 if arch == "stablelm_3b" and b == 4 else 12
        eng = ServingEngine(cfg, params, slots=4, max_len=40, device="cpu",
                            kernels="ref")
        prompt = replica.prompts(b, b, 24, cfg.vocab_size, "cpu")
        out = torch.as_tensor(eng.generate(prompt, steps).tokens)
        inp = torch.cat([prompt, out[:, :-1]], dim=1)
        ref = model_ref.logits(conf, params, inp, 23)
        gap = ref.max(-1).values - ref.gather(-1, out[..., None])[..., 0]
        assert float(gap.max()) <= 1e-4 * float(ref.abs().max())


def test_chunked_ssd_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 128, 3, 4, 5
    x = torch.randn(b, l, h, p, generator=g)
    dt = torch.rand(b, l, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) - 0.1
    bm = torch.randn(b, l, h, n, generator=g)
    cm = torch.randn(b, l, h, n, generator=g)
    state = torch.zeros(b, h, p, n)
    ys = []
    for t in range(l):
        state = torch.exp(dt[:, t, :, None, None] * a[None, :, None, None]) \
            * state + (dt[:, t, :, None, None] * x[:, t, :, :, None]) \
            * bm[:, t, :, None, :]
        ys.append((state * cm[:, t, :, None, :]).sum(-1))
    want = torch.stack(ys, dim=1)
    got = mamba2.ssd(x, dt, a, bm, cm, chunk=32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_control_rounds_every_matrix_to_fp8(arch):
    conf, _, params = setup(arch)
    q = model_ref.quantize_fp8(params)
    w = params["layers"][0]["attn" if arch == "stablelm_3b" else "mixer"]
    wq = q["layers"][0]["attn" if arch == "stablelm_3b" else "mixer"]
    key = "wq" if arch == "stablelm_3b" else "in_proj"
    rel = ((wq[key] - w[key]).norm() / w[key].norm()).item()
    assert 1e-3 < rel < 0.1
    norm_key = "norm1"
    assert torch.equal(q["layers"][0][norm_key]["scale"],
                       params["layers"][0][norm_key]["scale"])


@pytest.mark.parametrize("arch", ARCHS)
def test_configuration_keys_the_port_runs_otherwise_are_refused(arch):
    """A key with no port field must state what the port computes: the
    norm's epsilon, and (where the file has it) the rotary share or the
    gate's order."""
    conf = tiny.conf(arch)
    replica.arch_config(conf)
    bad = dict(conf, model=dict(conf["model"], norm_eps=1e-3))
    with pytest.raises(ValueError):
        replica.arch_config(bad)
    fixed = "partial_rotary_factor" if arch == "stablelm_3b" \
        else "norm_before_gate"
    bad = dict(conf, model=dict(conf["model"],
                                **{fixed: not conf["model"][fixed]}))
    with pytest.raises(ValueError):
        replica.arch_config(bad)
    bad = dict(conf, model=dict(conf["model"], rope_scaling=2.0))
    with pytest.raises(KeyError):
        replica.arch_config(bad)


def test_an_attn_config_with_grouped_heads_and_rmsnorm_needs_no_new_code():
    """A configuration of another ``attn`` model (grouped key/value heads,
    RMSNorm, as Phi-3) runs through the same weights, reference and
    counts as StableLM-3B's, by its file alone."""
    conf = tiny.conf("stablelm_3b")
    conf = dict(conf, name="grouped", port_config="phi3_medium_14b",
                model=dict(conf["model"], num_key_value_heads=2,
                           norm="rmsnorm", norm_eps=1e-6))
    cfg = replica.arch_config(conf)
    params = replica.make_params("attn", cfg, 3, "cpu")
    tokens = replica.prompts(5, 2, 20, cfg.vocab_size, "cpu")
    want, _ = model.forward(params, cfg, {"tokens": tokens}, kernels="ref")
    got = model_ref.logits(conf, params, tokens, 0)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
