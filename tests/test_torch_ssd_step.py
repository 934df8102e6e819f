"""The Mamba-2 decode state step: ``ssd_step`` (``ssd_step_kernel`` in
``csrc/ssd.cu``) and its plain version ``ssd_step_ref``.

On the CPU: the plain version is the decode step's former eager update
(kept here as ``state_step_before``, verbatim) bit for bit, at both
served head layouts (mamba2_370m: H 32 over G 1; Nemotron-H: H 64 over
G 8; P 64, N 128; Falcon-H1: H 32 over G 2, P 128, N 256) and at small ragged shapes, with x a strided view of
a conv output row as the decode step hands it over; the wrapper takes
the plain version for CPU tensors and the facade refuses ``"cuda"``
there. The model's decode step under ``kernels="ref"`` is held to the
JAX package in ``tests/test_torch_models.py`` and
``tests/test_torch_nemotron_h.py``.

Tests marked ``cuda`` run the kernel against the plain version on the
card and skip without one. The new state must equal the plain
version's bit for bit: the kernel keeps its rounding step for step. y
sums over N in another order: two float32 sums of the same N products,
each in any order, differ by at most N 2^-23 x sum |h c| (twice the
recursive-sum bound (N - 1) 2^-24 with the products' own rounding), and
the skip term's last add by 2^-23 |y| more. The file imports no JAX, so
``pytest -m cuda tests/test_torch_ssd_step.py`` runs on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_step as tstep
from repro_torch.models import model
from repro_torch.models.transformer import layer_kinds
from repro_torch.serving import ServingEngine

# (B, H, G, P, N): the three served head layouts (at B 2: the shapes of
# a head, not of the batch, are what they pin; Falcon-H1's P 128, N 256
# over two slices of rows and two float4s a lane), then ragged ones
SERVED = [(2, 32, 1, 64, 128), (2, 64, 8, 64, 128), (2, 32, 2, 128, 256)]
RAGGED = [(3, 3, 1, 5, 4), (1, 4, 2, 7, 12), (2, 6, 3, 24, 20),
          (5, 2, 2, 1, 8), (2, 4, 4, 40, 72), (1, 1, 1, 64, 128)]
# the card's extra cases: the served batches, and P / N at their limits
CARD = SERVED + RAGGED + [(64, 32, 1, 64, 128), (32, 64, 8, 64, 128),
                          (16, 32, 2, 128, 256), (3, 5, 1, 33, 124),
                          (2, 3, 3, 63, 4), (3, 5, 1, 100, 252),
                          (2, 3, 3, 65, 132)]


def state_step_before(h, dt1, a, xs1, b1, c1, d_skip):
    """One token's SSM recurrence: h (B, H, P, N) updated in place,
    returns y (B, H, P) float32 (the skip term included)."""
    decay = torch.exp(dt1 * a)                            # (B, H)
    h.mul_(decay[..., None, None]).add_(
        (dt1[..., None] * xs1)[..., None] * b1[:, :, None, :])
    yh = torch.einsum("bhpn,bhn->bhp", h, c1)             # (B, H, P)
    return yh + xs1 * d_skip[None, :, None]


def step_case(seed: int, b: int, h: int, g: int, p: int, n: int,
              device="cpu", cols: bool = False) -> list:
    """[h, dt, a, x, b, c, d_skip] as the decode step makes them: dt a
    softplus, a = -linspace(1, 16, H), x a view of a conv output row
    (x | B | C), B and C repeated from G groups over the heads. With
    ``cols`` the conv output is laid out by column (strides (1, B)), as
    the decode step's einsum leaves it on the card."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor(
            (rng.standard_normal(shape) * scale).astype(np.float32),
            device=device)
    conv = t(h * p + 2 * g * n, b).t() if cols \
        else t(b, h * p + 2 * g * n)
    xs = conv[:, :h * p].reshape(b, h, p)
    rep = h // g
    bb = conv[:, h * p:h * p + g * n].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)
    cc = conv[:, h * p + g * n:].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)
    dt = torch.nn.functional.softplus(t(b, h))
    a = -torch.linspace(1.0, 16.0, h, device=device)
    return [t(b, h, p, n), dt, a, xs, bb, cc, t(h)]


def y_tol(h_new: torch.Tensor, c: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """The bound of the module docstring, per element of y."""
    n = h_new.shape[-1]
    mass = (h_new * c[:, :, None, :]).abs().sum(-1)
    return n * 2.0 ** -23 * mass + 2.0 ** -23 * y.abs()


def case_id(case) -> str:
    return "b{}_h{}_g{}_p{}_n{}".format(*case)


@pytest.mark.parametrize("cols", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("case", SERVED + RAGGED, ids=case_id)
def test_plain_version_is_the_former_update_bit_for_bit(case, cols):
    args = step_case(sum(case), *case, cols=cols)
    before = [args[0].clone()] + args[1:]
    y_before = state_step_before(*before)
    h = args[0]
    y = ref.ssd_step_ref(*args)
    assert torch.equal(h, before[0])
    assert torch.equal(y, y_before)
    assert y.dtype == torch.float32 and y.shape == case[:2] + (case[3],)


@pytest.mark.parametrize("case", SERVED[:1] + RAGGED[:2], ids=case_id)
def test_the_wrapper_runs_the_plain_version_on_the_cpu(case):
    args = step_case(7 + sum(case), *case)
    want_h = args[0].clone()
    want = ref.ssd_step_ref(want_h, *args[1:])
    h, launches = args[0], tstep.ssd_step.launches
    got = tstep.ssd_step(*args)
    assert args[0] is h and torch.equal(h, want_h)
    assert torch.equal(got, want)
    assert tstep.ssd_step.launches == launches


@pytest.mark.parametrize("impl", ["ref", "fused"])
def test_dispatch_plain_paths(impl):
    args = step_case(11, *RAGGED[2])
    want_h = args[0].clone()
    want = ref.ssd_step_ref(want_h, *args[1:])
    got = ops.ssd_step(*args, impl=impl)
    assert torch.equal(args[0], want_h) and torch.equal(got, want)


def test_dispatch_cuda_refuses_cpu_tensors():
    args = step_case(12, *RAGGED[0])
    h0 = args[0].clone()
    with pytest.raises(ValueError, match="cuda"):
        ops.ssd_step(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_step(*args, impl="pallas")
    assert torch.equal(args[0], h0)


def test_the_wrapper_refuses_a_gradient():
    args = step_case(13, *RAGGED[0])
    args[3] = args[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        tstep.ssd_step(*args)


@pytest.mark.parametrize("cols", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("case", SERVED + RAGGED, ids=case_id)
def test_the_kernel_takes_the_decode_steps_layouts(case, cols):
    tstep.check_inputs(*step_case(14, *case, cols=cols))


def held_to_the_kernel(monkeypatch) -> list:
    """Route ``ops.ssd_step`` through ``check_inputs`` before the plain
    version; returns the list of checked calls."""
    calls = []

    def step(*args, impl="ref"):
        tstep.check_inputs(*args)
        calls.append(args[0].shape)
        return ref.ssd_step_ref(*args)
    monkeypatch.setattr(ops, "ssd_step", step)
    return calls


@pytest.mark.parametrize("arch", ["mamba2_370m", "nemotron_3_nano",
                                  "falcon_h1_34b"])
@pytest.mark.parametrize("b", [2, 3], ids=["b_lt_slots", "b_eq_slots"])
def test_the_engine_hands_the_kernel_what_it_takes(monkeypatch, arch, b):
    """Every state step of a served wave (both slot paths: states merged
    into the engine's cache, or the prefill's adopted) passes the
    kernel's checks; one call a Mamba-2 layer and decode step."""
    cfg = reduced(get_config(arch))
    if arch == "nemotron_3_nano":      # P 16, N 8 over 2 groups
        cfg = dataclasses.replace(
            get_config(arch), d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, vocab_size=97, n_experts=8, top_k=2,
            shared_d_ff=32, d_ff=48, ssm_heads=8, ssm_head_dim=16,
            ssm_state=8, ssm_groups=2, dtype="float32")
    params = model.init_params(cfg, seed=0, device="cpu")
    calls = held_to_the_kernel(monkeypatch)
    eng = ServingEngine(cfg, params, slots=3, max_len=32, device="cpu",
                        kernels="ref")
    prompt = torch.from_numpy(np.random.default_rng(b).integers(
        0, cfg.vocab_size, (b, 8)))
    eng.generate(prompt, steps=3)
    n_ssm = sum(k in ("mamba2", "hybrid_mamba", "parallel_hybrid")
                for k in layer_kinds(cfg))
    assert n_ssm and len(calls) == 2 * n_ssm


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have "
                    "no interpret mode (chip_smoke.py runs them on the "
                    "card)")
    return torch.device("cuda", 0)


def check_against_plain(args):
    """Run the kernel and the plain version on copies of ``args``' state;
    the states bit for bit, y within ``y_tol``. Returns the kernel's
    (h, y)."""
    want_h = args[0].clone()
    want = ref.ssd_step_ref(want_h, *args[1:])
    h, ptr = args[0], args[0].data_ptr()
    launches = tstep.ssd_step.launches
    got = tstep.ssd_step(*args)
    torch.cuda.synchronize()
    assert tstep.ssd_step.launches == launches + 1
    assert args[0] is h and h.data_ptr() == ptr
    assert torch.equal(h, want_h), \
        f"state differs at {(h != want_h).nonzero()[:4].tolist()}"
    err = (got - want).abs()
    tol = y_tol(h, args[5], want)
    assert bool((err <= tol).all()), \
        f"y off by {err.max().item()} (tol {tol.min().item()})"
    return h, got


@pytest.mark.cuda
class TestCudaSSDStepKernel:
    @pytest.mark.parametrize("cols", [False, True], ids=["rows", "cols"])
    @pytest.mark.parametrize("case", CARD, ids=case_id)
    def test_ssd_step_kernel(self, cuda_device, case, cols):
        b, h, g, p, n = case
        args = step_case(100 + sum(case), *case, device=cuda_device,
                         cols=cols)
        if b > 1:                                   # a view of the conv
            assert args[3].stride(0) == (1 if cols else h * p + 2 * g * n)
        check_against_plain(args)

    def test_every_layout_of_x_agrees(self, cuda_device):
        args = step_case(101, *SERVED[1], device=cuda_device)
        x = args[3]
        h0 = args[0].clone()
        got = check_against_plain(args)
        for other in (x.contiguous(), x.transpose(1, 2).contiguous()
                      .transpose(1, 2), x.permute(2, 1, 0).contiguous()
                      .permute(2, 1, 0)):
            again = check_against_plain([h0.clone()] + args[1:3] + [other]
                                        + args[4:])
            assert torch.equal(got[0], again[0])
            assert torch.equal(got[1], again[1])

    def test_steps_chain(self, cuda_device):
        """Eight steps in a row on the same state stay bit-equal."""
        args = step_case(102, *SERVED[0], device=cuda_device)
        want_h = args[0].clone()
        for k in range(8):
            ref.ssd_step_ref(want_h, *args[1:])
            tstep.ssd_step(*args)
        torch.cuda.synchronize()
        assert torch.equal(args[0], want_h)

    def test_a_replayed_graph_matches_eager(self, cuda_device):
        args = step_case(103, *SERVED[0], device=cuda_device)
        h0 = args[0].clone()
        eager_h = h0.clone()
        eager_y = tstep.ssd_step(eager_h, *args[1:])
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            tstep.ssd_step(h0.clone(), *args[1:])          # warm
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        static = h0.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = tstep.ssd_step(static, *args[1:])
        for _ in range(2):
            static.copy_(h0)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(static, eager_h)
            assert torch.equal(y, eager_y)

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        args = step_case(104, *RAGGED[2], device=cuda_device)

        def swap(i, value):
            return args[:i] + [value] + args[i + 1:]
        with pytest.raises(ValueError, match="N 6"):
            tstep.ssd_step(*step_case(105, 1, 2, 1, 8, 6,
                                      device=cuda_device))
        with pytest.raises(ValueError, match="N 260"):
            tstep.ssd_step(*step_case(106, 1, 2, 1, 8, 260,
                                      device=cuda_device))
        with pytest.raises(ValueError, match="P 129"):
            tstep.ssd_step(*step_case(107, 1, 2, 1, 129, 8,
                                      device=cuda_device))
        with pytest.raises(TypeError):
            tstep.ssd_step(*swap(0, args[0].double()))
        with pytest.raises(TypeError):
            tstep.ssd_step(*swap(3, args[3].to(torch.bfloat16)))
        with pytest.raises(ValueError, match="on cpu"):
            tstep.ssd_step(*swap(4, args[4].cpu()))
        with pytest.raises(ValueError, match="contiguous"):
            tstep.ssd_step(*swap(0, args[0].transpose(2, 3).contiguous()
                                 .transpose(2, 3)))
        with pytest.raises(ValueError, match="shape"):
            tstep.ssd_step(*swap(5, args[5][:, :-1]))
