"""The Mamba-2 decode mixer in three launches: ``ssd_conv_step``
(``ssd_conv_step_kernel``), ``ssd_state_step`` (``ssd_step_kernel`` with
B and C by group) and ``ssd_gated_norm`` (``ssd_gated_norm_kernel``),
and their plain versions ``ssd_conv_step_ref``, ``ssd_state_step_ref``
and ``ssd_gated_norm_ref``.

On the CPU: the decode step under ``kernels="cuda"`` with the facade's
device check lifted (the wrappers then run the plain versions) against
the same step under ``"ref"`` (the eager passes: an einsum conv, B and C
repeated over the heads, ``_gate_out``), for both gate orders and group
counts (1 group, rmsnorm(y) * silu(z); 8 groups, the gate first), in
float32 and bfloat16. The conv buffer is equal bit for bit; the SSM
state differs by the conv's sum order only (``state_tol``); the layer's
output is within ``LAYER_TOL`` in float32 and ``MODEL_BF16_TOL`` (the
model tests' bf16 bound) in bfloat16. Every served wave hands the
kernels arguments their checks take.

Tests marked ``cuda`` run the kernels against their plain versions on
the card at the served shapes, and skip without one: the conv output,
dt and the buffer bit for bit (both keep each rounding step); the state
bit for bit against ``ssd_step_ref`` given the same x, B, C and dt, y
within ``y_tol``; the norm within one rounding of the model dtype per
cast (``norm_tol``: only the sum of squares' order differs). The file
imports no JAX, so ``pytest -m cuda tests/test_torch_ssd_mixer.py`` runs
on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_step as tstep
from repro_torch.models import layers, model, ssm
from repro_torch.models.transformer import layer_kinds
from repro_torch.serving import ServingEngine
from test_torch_ssd_step import y_tol  # y's sum over N in another order

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_BF16_TOL = dict(atol=1e-3, rtol=1e-2)

# (base config, overrides): 1 group and rmsnorm(y) * silu(z); 8 groups
# and the gate first; then the served head layouts (P 64, N 128; and
# Falcon-H1's P 128, N 256 over 2 groups, the gate first) at a small
# d_model
ARCHS = {
    "g1": ("mamba2_370m", dict(ssm_heads=8, ssm_head_dim=16, ssm_state=16)),
    "g8": ("nemotron_3_nano", dict(ssm_heads=16, ssm_head_dim=8,
                                   ssm_state=8, ssm_groups=8)),
    "served_g1": ("mamba2_370m", dict(ssm_heads=32, ssm_head_dim=64,
                                      ssm_state=128)),
    "served_g8": ("nemotron_3_nano", dict(ssm_heads=64, ssm_head_dim=64,
                                          ssm_state=128, ssm_groups=8)),
    "served_g2": ("falcon_h1_34b", dict(ssm_heads=32, ssm_head_dim=128,
                                        ssm_state=256, ssm_groups=2)),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def arch_config(arch: str, dtype: torch.dtype):
    base, kw = ARCHS[arch]
    return dataclasses.replace(get_config(base), d_model=64,
                               dtype=str(dtype).removeprefix("torch."), **kw)


def layer_case(arch: str, dtype: torch.dtype, bsz: int, seed: int,
               device="cpu"):
    """(cfg, params, state, x) of one Mamba-2 layer: the init's weights
    with the biases, d_skip and the norm's scale drawn away from their
    zero / one init (head 0's dt bias 25, past softplus's threshold), a
    random conv buffer and SSM state."""
    cfg = arch_config(arch, dtype)
    p = ssm.init(layers.Init(seed, device), cfg, dtype)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def normal(shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    p["conv_b"] = normal(p["conv_b"].shape, 0.1).to(dtype)
    p["dt_bias"] = normal(p["dt_bias"].shape, 0.5)
    p["dt_bias"][0] = 25.0
    p["d_skip"] = normal(p["d_skip"].shape)
    p["norm"]["scale"] = normal(p["norm"]["scale"].shape, 0.2)
    dd = ssm.dims(cfg)
    state = {"conv": normal((bsz, dd["conv_w"] - 1, dd["conv_ch"]))
             .to(dtype),
             "ssm": normal((bsz, dd["n_heads"], dd["head_dim"],
                            dd["state"]))}
    return cfg, p, state, normal((bsz, 1, cfg.d_model)).to(dtype)


def clone_state(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items()}


def lift_device_check(monkeypatch) -> None:
    """Let ``impl="cuda"`` take CPU tensors: the wrappers then run the
    plain versions (what the chip rehearsals on the CPU do)."""
    monkeypatch.setattr(ops, "_require_cuda", lambda op, x, impl: None)


def state_tol(p: dict, cfg, x: torch.Tensor, state: dict) -> torch.Tensor:
    """Per element of the new SSM state: two sums of the conv's W float32
    products in different orders (with or without fused multiply-adds)
    differ by at most W 2^-23 of their magnitude; with the bias and the
    SiLU that is within E = 2^-20 (sum |e w| + |bias|) per channel, and
    the update dt x b moves by dt (E_x |b| + |x| E_b + E_x E_b); the
    update's own roundings can land apart by 2^-22 of its terms."""
    dd = ssm.dims(cfg)
    d_in, ch, gn = dd["d_in"], dd["conv_ch"], dd["groups"] * dd["state"]
    proj = layers.matmul(x, p["in_proj"])[:, 0]
    ext = torch.cat([state["conv"], proj[:, None, d_in:d_in + ch]], dim=1)
    mass = (ext.float() * p["conv_w"].float()).abs().sum(1) \
        + p["conv_b"].float().abs()
    err = 2.0 ** -20 * mass
    conv, dt = ref.ssd_conv_step_ref(
        proj[:, d_in:d_in + ch], proj[:, d_in + ch:], state["conv"].clone(),
        p["conv_w"], p["conv_b"], p["dt_bias"])
    rep = dd["n_heads"] // dd["groups"]

    def heads(t):
        return t[:, :d_in].unflatten(1, (dd["n_heads"], dd["head_dim"]))

    def groups(t, k):
        return t[:, d_in + k * gn:d_in + (k + 1) * gn].unflatten(
            1, (dd["groups"], dd["state"])).repeat_interleave(rep, dim=1)
    xs, ex, b, eb = heads(conv), heads(err), groups(conv, 0), groups(err, 0)
    dtx = dt[..., None, None]
    moved = dtx * (ex[..., None] * b[:, :, None].abs()
                   + xs[..., None].abs() * eb[:, :, None]
                   + ex[..., None] * eb[:, :, None])
    decay = torch.exp(dt * -torch.exp(p["a_log"]))[..., None, None]
    terms = (state["ssm"] * decay).abs() \
        + (dtx * xs[..., None] * b[:, :, None]).abs()
    return moved + 2.0 ** -22 * terms + 1e-30


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("bsz", [1, 5])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_composed_plain_versions_are_the_eager_step(monkeypatch, arch,
                                                        dtype, bsz):
    """``decode_step`` under ``"cuda"`` (the three wrappers, each on its
    plain version here) against the eager step under ``"ref"``."""
    dt_ = DTYPES[dtype]
    cfg, p, state, x = layer_case(arch, dt_, bsz, 7 + bsz)
    tol = state_tol(p, cfg, x, state)
    eager = clone_state(state)
    want, _ = ssm.decode_step(p, cfg, x, eager, kernels="ref")
    lift_device_check(monkeypatch)
    launches = [f.launches for f in (tstep.ssd_conv_step,
                                     tstep.ssd_state_step,
                                     tstep.ssd_gated_norm)]
    got, out_state = ssm.decode_step(p, cfg, x, state, kernels="cuda")
    assert out_state is state
    assert torch.equal(state["conv"], eager["conv"])
    err = (state["ssm"] - eager["ssm"]).abs()
    assert bool((err <= tol).all()), \
        f"state off by {(err / tol).max().item()} of its bound"
    assert got.dtype == want.dtype == dt_ and got.shape == (bsz, 1,
                                                             cfg.d_model)
    torch.testing.assert_close(
        got.float(), want.float(),
        **(MODEL_BF16_TOL if dt_ == torch.bfloat16 else LAYER_TOL))
    # on the CPU the wrappers run the plain versions and count nothing
    assert launches == [f.launches for f in (tstep.ssd_conv_step,
                                             tstep.ssd_state_step,
                                             tstep.ssd_gated_norm)]


@pytest.mark.parametrize("gate_first", [False, True], ids=["y_first",
                                                           "gate_first"])
def test_the_plain_norm_is_the_gate_out_of_the_step(gate_first):
    """``ssd_gated_norm_ref`` then out_proj is ``_gate_out`` of y cast to
    the model dtype, bit for bit, in both gate orders."""
    arch = "g8" if gate_first else "g1"
    cfg, p, _, _ = layer_case(arch, torch.bfloat16, 3, 21)
    d_in = ssm.dims(cfg)["d_in"]
    gen = torch.Generator().manual_seed(22)
    y = torch.randn((3, d_in), generator=gen)
    z = torch.randn((3, d_in), generator=gen).to(torch.bfloat16)
    want = ssm._gate_out(p, cfg, y[:, None].to(torch.bfloat16), z[:, None],
                         torch.bfloat16)
    n = ref.ssd_gated_norm_ref(y, z, p["norm"]["scale"],
                               cfg.ssm_groups if gate_first else 1,
                               gate_first, cfg.norm_eps or 1e-6)
    assert n.dtype == torch.bfloat16
    assert torch.equal(layers.matmul(n[:, None], p["out_proj"]), want)


def test_the_plain_conv_step_is_its_window_in_tap_order():
    """``ssd_conv_step_ref``: the window's products summed tap by tap in
    float32, SiLU, the buffer shifted by one, dt a softplus."""
    gen = torch.Generator().manual_seed(23)
    buf = torch.randn((2, 3, 10), generator=gen).to(torch.bfloat16)
    u = torch.randn((2, 10), generator=gen).to(torch.bfloat16)
    w = torch.randn((4, 10), generator=gen).to(torch.bfloat16)
    bias = torch.randn(10, generator=gen).to(torch.bfloat16)
    dt_raw = torch.randn((2, 3), generator=gen).to(torch.bfloat16)
    dt_bias = torch.tensor([0.5, -1.0, 25.0])
    before = buf.clone()
    out, dt = ref.ssd_conv_step_ref(u, dt_raw, buf, w, bias, dt_bias)
    acc = before[:, 0].float() * w[0].float()
    acc = acc + before[:, 1].float() * w[1].float()
    acc = acc + before[:, 2].float() * w[2].float()
    acc = acc + u.float() * w[3].float()
    assert torch.equal(out, torch.nn.functional.silu(acc + bias.float()))
    assert torch.equal(buf, torch.cat([before[:, 1:], u[:, None]], 1))
    v = dt_raw.float() + dt_bias
    assert torch.equal(dt, torch.where(v > 20, v, torch.log1p(torch.exp(v))))


def test_the_plain_state_step_is_ssd_step_over_repeated_groups():
    gen = torch.Generator().manual_seed(24)
    h = torch.randn((2, 6, 5, 8), generator=gen)
    conv = torch.randn((2, 6 * 5 + 2 * 3 * 8), generator=gen)
    x = conv[:, :30].unflatten(1, (6, 5))
    b = conv[:, 30:54].unflatten(1, (3, 8))
    c = conv[:, 54:].unflatten(1, (3, 8))
    dt = torch.rand((2, 6), generator=gen)
    a_log = torch.randn(6, generator=gen)
    d_skip = torch.randn(6, generator=gen)
    want_h = h.clone()
    want = ref.ssd_step_ref(want_h, dt, -torch.exp(a_log), x,
                            b.repeat_interleave(2, 1),
                            c.repeat_interleave(2, 1), d_skip)
    got = ref.ssd_state_step_ref(h, dt, a_log, x, b, c, d_skip)
    assert torch.equal(h, want_h) and torch.equal(got, want)


def mixer_args(arch: str, dtype: torch.dtype, bsz: int, seed: int,
               device="cpu") -> dict:
    """Each kernel's arguments as ``ssm._mixer_kernels`` hands them over:
    views of one in_proj output and of one conv output."""
    cfg, p, state, x = layer_case(arch, dtype, bsz, seed, device)
    dd = ssm.dims(cfg)
    d_in, ch, gn = dd["d_in"], dd["conv_ch"], dd["groups"] * dd["state"]
    proj = layers.matmul(x, p["in_proj"])[:, 0]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    conv = torch.randn((bsz, ch), generator=gen, device=device)
    return {
        "conv": [proj[:, d_in:d_in + ch], proj[:, d_in + ch:],
                 state["conv"], p["conv_w"], p["conv_b"], p["dt_bias"]],
        "state": [state["ssm"],
                  torch.nn.functional.softplus(torch.randn(
                      (bsz, dd["n_heads"]), generator=gen, device=device)),
                  p["a_log"],
                  conv[:, :d_in].unflatten(1, (dd["n_heads"],
                                               dd["head_dim"])),
                  conv[:, d_in:d_in + gn].unflatten(1, (dd["groups"],
                                                        dd["state"])),
                  conv[:, d_in + gn:].unflatten(1, (dd["groups"],
                                                    dd["state"])),
                  p["d_skip"]],
        "norm": [torch.randn((bsz, d_in), generator=gen, device=device),
                 proj[:, :d_in], p["norm"]["scale"],
                 cfg.ssm_groups if cfg.ssm_gate_first else 1,
                 cfg.ssm_gate_first, cfg.norm_eps or 1e-6]}


WRAPPERS = {"conv": (tstep.ssd_conv_step, ref.ssd_conv_step_ref,
                     ops.ssd_conv_step, 2),
            "state": (tstep.ssd_state_step, ref.ssd_state_step_ref,
                      ops.ssd_state_step, 0),
            "norm": (tstep.ssd_gated_norm, ref.ssd_gated_norm_ref,
                     ops.ssd_gated_norm, None)}


def plain_and(fn, args: list, mutated):
    """(fn's result, the argument it updates in place after the call),
    on copies of that argument."""
    args = list(args)
    if mutated is not None:
        args[mutated] = args[mutated].clone()
    out = fn(*args)
    return out, (None if mutated is None else args[mutated])


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_the_wrappers_run_the_plain_versions_on_the_cpu(which):
    wrapper, plain, _, mutated = WRAPPERS[which]
    args = mixer_args("g8", torch.bfloat16, 3, 30)[which]
    want, want_m = plain_and(plain, args, mutated)
    launches = wrapper.launches
    got, got_m = plain_and(wrapper, args, mutated)
    assert same(got, want) and same(got_m, want_m)
    assert wrapper.launches == launches


@pytest.mark.parametrize("impl", ["ref", "fused"])
@pytest.mark.parametrize("which", list(WRAPPERS))
def test_dispatch_plain_paths(which, impl):
    _, plain, facade, mutated = WRAPPERS[which]
    args = mixer_args("g1", torch.float32, 2, 31)[which]
    want, want_m = plain_and(plain, args, mutated)
    got, got_m = plain_and(lambda *a: facade(*a, impl=impl), args, mutated)
    assert same(got, want) and same(got_m, want_m)


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_dispatch_cuda_refuses_cpu_tensors(which):
    _, _, facade, _ = WRAPPERS[which]
    args = mixer_args("g1", torch.float32, 2, 32)[which]
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cuda"):
        facade(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        facade(*args, impl="pallas")
    assert all(torch.equal(a, b) for a, b in zip(args, before)
               if isinstance(a, torch.Tensor))


def test_a_cpu_step_under_cuda_refuses():
    cfg, p, state, x = layer_case("g1", torch.float32, 2, 33)
    with pytest.raises(ValueError, match="cuda"):
        ssm.decode_step(p, cfg, x, state, kernels="cuda")


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_the_wrappers_refuse_a_gradient(which):
    wrapper, _, _, _ = WRAPPERS[which]
    args = mixer_args("g1", torch.float32, 2, 34)[which]
    i = 3 if which == "state" else 0
    args[i] = args[i].detach().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        wrapper(*args)


CHECKS = {"conv": tstep.check_conv_inputs, "state": tstep.check_state_inputs,
          "norm": lambda y, z, scale, groups, *_: tstep.check_norm_inputs(
              y, z, scale, groups)}


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_kernels_take_the_mixers_layouts(arch, dtype):
    for which, args in mixer_args(arch, DTYPES[dtype], 3, 35).items():
        CHECKS[which](*args)


def held_to_the_kernels(monkeypatch) -> list:
    """Route the mixer's three ops through their kernels' checks before
    the plain versions; returns the checked calls' names."""
    calls = []
    lift_device_check(monkeypatch)
    for which, (_, plain, facade, _) in WRAPPERS.items():
        def op(*args, impl="ref", which=which, plain=plain):
            assert impl == "cuda"
            CHECKS[which](*args)
            calls.append(which)
            return plain(*args)
        monkeypatch.setattr(ops, facade.__name__, op)
    return calls


@pytest.mark.parametrize("arch", ["mamba2_370m", "nemotron_3_nano",
                                  "falcon_h1_34b"])
@pytest.mark.parametrize("b", [2, 3], ids=["b_lt_slots", "b_eq_slots"])
def test_the_engine_hands_the_kernels_what_they_take(monkeypatch, arch, b):
    """Every decode step of a served wave under ``"cuda"`` (both slot
    paths: states merged into the engine's cache, or the prefill's
    adopted) passes the three kernels' checks; each kernel once a
    Mamba-2 layer and step."""
    cfg = reduced(get_config(arch))
    if arch == "nemotron_3_nano":      # P 16, N 8 over 2 groups
        cfg = dataclasses.replace(
            get_config(arch), d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, vocab_size=97, n_experts=8, top_k=2,
            shared_d_ff=32, d_ff=48, ssm_heads=8, ssm_head_dim=16,
            ssm_state=8, ssm_groups=2, dtype="float32")
    params = model.init_params(cfg, seed=0, device="cpu")
    calls = held_to_the_kernels(monkeypatch)
    eng = ServingEngine(cfg, params, slots=3, max_len=32, device="cpu",
                        kernels="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (b, 8),
                           generator=torch.Generator().manual_seed(b))
    eng.generate(prompt, steps=3)
    n_ssm = sum(k in ("mamba2", "hybrid_mamba", "parallel_hybrid")
                for k in layer_kinds(cfg))
    assert n_ssm and calls == ["conv", "state", "norm"] * (2 * n_ssm)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have "
                    "no interpret mode (chip_smoke.py runs them on the "
                    "card)")
    return torch.device("cuda", 0)


# the served steps: mamba2_370m's 64 slots x 32 heads over 1 group,
# Nemotron's 32 slots x 64 heads over 8 groups and Falcon-H1's 16 slots x
# 32 heads of P 128, N 256 over 2 groups; then a small batch
SERVED = [("served_g1", 64), ("served_g8", 32), ("served_g2", 16),
          ("g1", 3), ("g8", 5)]


def served_id(case) -> str:
    return f"{case[0]}_b{case[1]}"


def norm_tol(want: torch.Tensor, gate_first: bool) -> torch.Tensor:
    """The norm's sum of squares in another order moves r by a few 2^-24;
    each cast to the model dtype can then round the other way: one unit
    in the last place of the result per cast (two casts stack without
    the gate first), float32's 2^-20 beside them."""
    one = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2.0 ** -20
    return (1 if gate_first else 2) * one * want.float().abs() + 1e-30


def run_kernel(which: str, args: list):
    wrapper, plain, _, mutated = WRAPPERS[which]
    want, want_m = plain_and(plain, args, mutated)
    launches = wrapper.launches
    got, got_m = plain_and(wrapper, args, mutated)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    return got, got_m, want, want_m


@pytest.mark.cuda
class TestCudaSSDMixerKernels:
    @pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
    @pytest.mark.parametrize("case", SERVED, ids=served_id)
    def test_ssd_conv_step_kernel(self, cuda_device, case, dtype):
        args = mixer_args(*case[:1], DTYPES[dtype], case[1], 40,
                          cuda_device)["conv"]
        (out, dt), buf, (want_out, want_dt), want_buf = \
            run_kernel("conv", args)
        assert torch.equal(buf, want_buf)
        assert torch.equal(out, want_out), \
            f"conv off by {(out - want_out).abs().max().item()}"
        assert torch.equal(dt, want_dt), \
            f"dt off by {(dt - want_dt).abs().max().item()}"

    @pytest.mark.parametrize("case", SERVED, ids=served_id)
    def test_ssd_state_step_is_ssd_steps_plain_version(self, cuda_device,
                                                       case):
        """The state bit for bit against ``ssd_step_ref`` given the same
        x, B (repeated over the heads), C and dt, and a = -exp(a_log)."""
        h, dt, a_log, x, b, c, d_skip = mixer_args(
            case[0], torch.bfloat16, case[1], 41, cuda_device)["state"]
        rep = h.shape[1] // b.shape[1]
        want_h = h.clone()
        want = ref.ssd_step_ref(want_h, dt, -torch.exp(a_log), x,
                                b.repeat_interleave(rep, 1).contiguous(),
                                c.repeat_interleave(rep, 1).contiguous(),
                                d_skip)
        launches = tstep.ssd_state_step.launches
        got = tstep.ssd_state_step(h, dt, a_log, x, b, c, d_skip)
        torch.cuda.synchronize()
        assert tstep.ssd_state_step.launches == launches + 1
        assert torch.equal(h, want_h), \
            f"state differs at {(h != want_h).nonzero()[:4].tolist()}"
        err = (got - want).abs()
        tol = y_tol(h, c.repeat_interleave(rep, 1), want)
        assert bool((err <= tol).all()), \
            f"y off by {err.max().item()} (tol {tol.min().item()})"

    @pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
    @pytest.mark.parametrize("case", SERVED, ids=served_id)
    def test_ssd_gated_norm_kernel(self, cuda_device, case, dtype):
        args = mixer_args(*case[:1], DTYPES[dtype], case[1], 42,
                          cuda_device)["norm"]
        got, _, want, _ = run_kernel("norm", args)
        assert got.dtype == want.dtype and got.is_contiguous()
        err = (got.float() - want.float()).abs()
        tol = norm_tol(want, args[4])
        assert bool((err <= tol).all()), \
            f"norm off by {(err / tol).max().item()} of its bound"

    @pytest.mark.parametrize("case", SERVED[:3], ids=served_id)
    def test_steps_chain(self, cuda_device, case):
        """Eight decode steps of one layer in a row on the same state:
        the kernels' buffer and state stay bit-equal to the plain
        versions', the output within the bf16 bound."""
        cfg, p, state, _ = layer_case(case[0], torch.bfloat16, case[1], 43,
                                      cuda_device)
        plain = clone_state(state)
        gen = torch.Generator(device=cuda_device).manual_seed(44)
        for _ in range(8):
            x = torch.randn((case[1], 1, cfg.d_model), generator=gen,
                            device=cuda_device).to(torch.bfloat16)
            got, _ = ssm.decode_step(p, cfg, x, state, kernels="cuda")
            want = plain_step(p, cfg, x, plain)
            torch.testing.assert_close(got.float(), want.float(),
                                       **MODEL_BF16_TOL)
        torch.cuda.synchronize()
        assert torch.equal(state["conv"], plain["conv"])
        assert torch.equal(state["ssm"], plain["ssm"])

    def test_a_replayed_graph_matches_eager(self, cuda_device):
        cfg, p, state, x = layer_case("served_g8", torch.bfloat16, 32, 45,
                                      cuda_device)
        eager = clone_state(state)
        want, _ = ssm.decode_step(p, cfg, x, eager, kernels="cuda")
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            ssm.decode_step(p, cfg, x, clone_state(state), kernels="cuda")
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        static = clone_state(state)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = ssm.decode_step(p, cfg, x, static, kernels="cuda")
        for _ in range(2):
            for k in static:
                static[k].copy_(state[k])
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            assert all(torch.equal(static[k], eager[k]) for k in static)

    def test_kernels_reject_what_they_do_not_take(self, cuda_device):
        args = mixer_args("g8", torch.bfloat16, 3, 46, cuda_device)

        def swap(which, i, value):
            a = list(args[which])
            a[i] = value
            return a
        conv, st, norm = (tstep.ssd_conv_step, tstep.ssd_state_step,
                          tstep.ssd_gated_norm)
        buf, w = args["conv"][2], args["conv"][3]
        with pytest.raises(ValueError, match="W 9"):
            conv(*args["conv"][:2], buf.new_zeros((3, 8, buf.shape[2])),
                 torch.cat([w, w[:5]]), *args["conv"][4:])
        with pytest.raises(TypeError):
            conv(*swap("conv", 2, buf.to(torch.float16)))
        with pytest.raises(TypeError):
            conv(*swap("conv", 3, w.float()))
        with pytest.raises(ValueError, match="contiguous"):
            conv(*swap("conv", 0, args["conv"][0].t().contiguous().t()))
        with pytest.raises(ValueError, match="shape"):
            conv(*swap("conv", 5, args["conv"][5][:-1]))
        h, b = args["state"][0], args["state"][4]
        with pytest.raises(ValueError, match="G dividing"):
            st(*swap("state", 4, b[:, :3]))
        shifted = b.new_empty((3, b[0].numel() + 1))[:, 1:]
        with pytest.raises(ValueError, match="aligned"):
            st(*swap("state", 4, shifted.unflatten(1, b.shape[1:])))
        with pytest.raises(ValueError, match="row strides"):
            st(*swap("state", 5, args["state"][5].contiguous()))
        with pytest.raises(ValueError, match="N 6"):
            st(h[..., :6].contiguous(), *args["state"][1:])
        with pytest.raises(TypeError):
            st(*swap("state", 2, args["state"][2].double()))
        with pytest.raises(ValueError, match="divide"):
            norm(*swap("norm", 3, 3))
        with pytest.raises(TypeError):
            norm(*swap("norm", 1, args["norm"][1].to(torch.float16)))
        with pytest.raises(ValueError, match="on cpu"):
            norm(*swap("norm", 2, args["norm"][2].cpu()))


def plain_step(p, cfg, x, state):
    """The layer's step through the three plain versions, in the order
    and on the views of ``ssm._mixer_kernels``."""
    dd = ssm.dims(cfg)
    d_in, ch, gn = dd["d_in"], dd["conv_ch"], dd["groups"] * dd["state"]
    proj = layers.matmul(x, p["in_proj"])[:, 0]
    conv, dt = ref.ssd_conv_step_ref(proj[:, d_in:d_in + ch],
                                     proj[:, d_in + ch:], state["conv"],
                                     p["conv_w"], p["conv_b"], p["dt_bias"])
    y = ref.ssd_state_step_ref(
        state["ssm"], dt, p["a_log"],
        conv[:, :d_in].unflatten(1, (dd["n_heads"], dd["head_dim"])),
        conv[:, d_in:d_in + gn].unflatten(1, (dd["groups"], dd["state"])),
        conv[:, d_in + gn:].unflatten(1, (dd["groups"], dd["state"])),
        p["d_skip"])
    n = ref.ssd_gated_norm_ref(
        y.flatten(1), proj[:, :d_in], p["norm"]["scale"],
        cfg.ssm_groups if cfg.ssm_gate_first else 1, cfg.ssm_gate_first,
        cfg.norm_eps or 1e-6)
    return layers.matmul(n[:, None], p["out_proj"])
