"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``), on the CPU.

Both sides run the reduced ``recurrentgemma_2b`` widths (d_model 256,
recurrent width 256, conv width 4) on inputs drawn with numpy from stated
seeds. The block weights are the reference's ``rglru.init`` from
``jax.random.PRNGKey(0)``, except the diagonal gates ``w_a``, ``b_a``,
``w_x``, ``b_x``, which are drawn at random: the reference inits them to
zero, which makes r and i a constant 0.5 and would hide a wrong product
in the gates. Λ is drawn over [-4, 4] for the same reason.

Tolerances: block outputs and states ``atol = rtol = 2e-5`` in float32
(the reference's own kernel bound). The port's recurrence is a doubling
scan and the reference's ``lax.associative_scan`` groups its products
differently, so the two agree to float32 rounding; the largest gap
measured over these cases is below 2e-6. The conv buffer of
``_causal_conv`` is a copy of its input and matches exactly; a block's
buffer holds its input projection, a GEMM whose sums the two frameworks
order differently, so it is held to the same tolerance. ``lam``'s init
matches within ``rtol = 1e-5``: XLA folds the reference's ``linspace``
into reciprocal multiplies, one float32 ulp off ``torch.linspace`` at
some points, which ``-log(x) / 8`` near x = 1 magnifies to 5.6e-6
relative at width 2560. The gated input's factor sqrt(1 - a²) is held
to a bound widened by its conditioning near a = 1
(``test_gates_match_the_reference``). In bf16 the outputs match within
``atol = rtol = 2e-2`` (a few bf16 steps: the projections round to bf16
on both sides, in a different order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as tl
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def t_of(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def cfg_pair():
    return (j_reduced(j_get_config("recurrentgemma_2b")),
            reduced(get_config("recurrentgemma_2b")))


def block_pair(seed: int = 0, dtype=jnp.float32):
    """Reference block weights with random gates and Λ, as jax and torch
    dicts (the torch leaves carry the same bits)."""
    jc, tc = cfg_pair()
    jp = jrg.init(jax.random.PRNGKey(seed), jc, dtype)
    rng = np.random.default_rng(100 + seed)
    w = trg.width(tc)
    for key in ("w_a", "w_x"):
        jp[key] = jnp.asarray(rng.normal(size=w).astype(np.float32))
    for key in ("b_a", "b_x"):
        jp[key] = jnp.asarray(rng.normal(size=w).astype(np.float32) * 0.5)
    jp["lam"] = jnp.asarray(rng.uniform(-4, 4, size=w).astype(np.float32))
    tp = {k: to_torch(v) for k, v in jp.items()}
    return jc, tc, jp, tp


def to_torch(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def state_of(rng, tc, b: int) -> dict:
    w = trg.width(tc)
    return {"conv": rng.normal(size=(b, tc.conv_width - 1, w))
            .astype(np.float32),
            "h": rng.normal(size=(b, w)).astype(np.float32)}


# ----------------------------------------------------------------- init --
def test_init_shapes_and_values_follow_the_reference():
    jc, tc = cfg_pair()
    want = jrg.init(jax.random.PRNGKey(0), jc, jnp.float32)
    got = trg.init(tl.Init(0, "cpu"), tc, torch.float32)
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    for key in ("conv_b", "w_a", "b_a", "w_x", "b_x"):
        np.testing.assert_array_equal(np_of(got[key]), np.asarray(want[key]))
    np.testing.assert_allclose(np_of(got["lam"]), np.asarray(want["lam"]),
                               rtol=1e-5, atol=0)
    assert abs(got["conv_w"].std().item() - 0.1) < 0.02
    d = tc.d_model
    assert abs(got["in_proj"].std().item() - d ** -0.5) < 0.05 * d ** -0.5
    bf = trg.init(tl.Init(0, "cpu"), tc, torch.bfloat16)
    assert {k: v.dtype for k, v in bf.items()} == {
        "in_proj": torch.bfloat16, "conv_w": torch.bfloat16,
        "conv_b": torch.bfloat16, "w_a": torch.float32,
        "b_a": torch.float32, "w_x": torch.float32, "b_x": torch.float32,
        "lam": torch.float32, "out_proj": torch.bfloat16}


def test_full_width_lam_follows_the_reference():
    """Λ at the published recurrent width (2560), where the linspace
    steps are finest."""
    cfg = get_config("recurrentgemma_2b")
    want = jrg.init(jax.random.PRNGKey(0), j_get_config("recurrentgemma_2b"),
                    jnp.bfloat16)["lam"]
    got = trg.init(tl.Init(0, "cpu"), cfg, torch.bfloat16)["lam"]
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5,
                               atol=0)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(got))
    assert 0.899 < a.min().item() < 0.901 and 0.998 < a.max().item() < 1.0


# ---------------------------------------------------------------- gates --
def test_gates_match_the_reference():
    """a_t and the gated input over Λ in [-10, 30], past 20 where
    ``F.softplus`` would switch to the identity and ``logaddexp`` does
    not. a_t is held to ``LAYER_TOL``. The gated input's factor
    sqrt(1 - a²) is ill-conditioned where a is near 1 (a small r at
    Λ ≈ -9 gives 1 - a² ≈ 2e-6): there the two frameworks' exp, each
    within an ulp, differ by up to 2^-23 in a², which moves the factor
    by 2^-23 / (2 sqrt(1 - a²)). The gated input is held to
    ``LAYER_TOL`` plus that much times |i x|."""
    jc, tc, jp, tp = block_pair()
    rng = np.random.default_rng(5)
    w = trg.width(tc)
    lam = np.linspace(-10, 30, w).astype(np.float32)
    jp["lam"], tp["lam"] = jnp.asarray(lam), t_of(lam)
    x = rng.normal(size=(3, 7, w)).astype(np.float32) * 2
    ja, jg = jrg._gates(jp, jnp.asarray(x))
    ta, tg = trg._gates(tp, t_of(x))
    np.testing.assert_allclose(np_of(ta), np.asarray(ja), **LAYER_TOL)
    assert ta.dtype == tg.dtype == torch.float32
    a = np.asarray(ja).astype(np.float64)
    i = 1 / (1 + np.exp(-(np.asarray(jp["w_x"]) * x + np.asarray(jp["b_x"]))))
    cond = np.abs(i * x) * 2.0 ** -23 / (2 * np.sqrt(np.maximum(1 - a * a,
                                                                1e-12)))
    want = np.asarray(jg)
    gap = np.abs(np_of(tg) - want)
    assert (gap <= 2e-5 + 2e-5 * np.abs(want) + cond).all(), gap.max()


# ----------------------------------------------------------------- conv --
@pytest.mark.parametrize("with_buf", [False, True])
def test_causal_conv_without_silu(with_buf):
    jc, tc, jp, tp = block_pair()
    rng = np.random.default_rng(30)
    w = trg.width(tc)
    u = rng.normal(size=(2, 9, w)).astype(np.float32)
    buf = rng.normal(size=(2, tc.conv_width - 1, w)).astype(np.float32) \
        if with_buf else None
    jy, jbuf = jssm._causal_conv(jp["conv_w"], jp["conv_b"], jnp.asarray(u),
                                 None if buf is None else jnp.asarray(buf),
                                 silu=False)
    ty, tbuf = tssm._causal_conv(tp["conv_w"], tp["conv_b"], t_of(u),
                                 None if buf is None else t_of(buf),
                                 silu=False)
    np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_array_equal(np_of(tbuf), np.asarray(jbuf))
    assert tbuf.is_contiguous()
    silu, _ = tssm._causal_conv(tp["conv_w"], tp["conv_b"], t_of(u),
                                None if buf is None else t_of(buf))
    torch.testing.assert_close(silu, torch.nn.functional.silu(ty),
                               rtol=0, atol=0)


# ----------------------------------------------------------------- scan --
@pytest.mark.parametrize("length", [1, 2, 3, 64, 65, 100])
def test_linear_scan_matches_the_recurrence(length):
    rng = np.random.default_rng(40 + length)
    a = rng.uniform(0.5, 1.0, size=(2, length, 8)).astype(np.float64)
    b = rng.normal(size=(2, length, 8)).astype(np.float64)
    h = np.zeros((2, 8))
    want = []
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = trg.linear_scan(t_of(a), t_of(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# -------------------------------------------------------------- forward --
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [1, 77])
def test_forward(with_state, length):
    """A sequence of 77 steps (no power of two) or 1, from zeros or from a
    carried conv buffer and hidden state, with the state after."""
    jc, tc, jp, tp = block_pair()
    rng = np.random.default_rng(31 + length)
    x = rng.normal(size=(2, length, tc.d_model)).astype(np.float32)
    st = state_of(rng, tc, 2) if with_state else None
    jy, jst = jrg.forward(jp, jc, jnp.asarray(x),
                          None if st is None else
                          jax.tree.map(jnp.asarray, st), return_state=True)
    ty, tst = trg.forward(tp, tc, t_of(x), None if st is None else
                          jax.tree.map(t_of, st), return_state=True)
    np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(np_of(tst[key]), np.asarray(jst[key]),
                                   **LAYER_TOL)
    assert tst["h"].is_contiguous() and tst["h"].dtype == torch.float32
    plain = trg.forward(tp, tc, t_of(x), None if st is None else
                        jax.tree.map(t_of, st))
    torch.testing.assert_close(plain, ty, rtol=0, atol=0)


def test_decode_step_updates_the_state_in_place():
    jc, tc, jp, tp = block_pair()
    rng = np.random.default_rng(32)
    st = state_of(rng, tc, 3)
    jst = jax.tree.map(jnp.asarray, st)
    tst = jax.tree.map(t_of, st)
    conv, h = tst["conv"], tst["h"]
    for _ in range(4):
        x = rng.normal(size=(3, 1, tc.d_model)).astype(np.float32)
        jy, jst = jrg.decode_step(jp, jc, jnp.asarray(x), jst)
        ty, tst = trg.decode_step(tp, tc, t_of(x), tst)
        np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
        for key in ("conv", "h"):
            np.testing.assert_allclose(np_of(tst[key]), np.asarray(jst[key]),
                                       **LAYER_TOL)
    assert tst["conv"] is conv and tst["h"] is h


def test_prefill_then_decode_continues_the_sequence():
    """forward over 40 steps with the state out, then decode steps,
    equals forward over the longer sequence at each new step."""
    _, tc, _, tp = block_pair()
    rng = np.random.default_rng(33)
    x = t_of(rng.normal(size=(2, 43, tc.d_model)).astype(np.float32))
    whole = trg.forward(tp, tc, x)
    _, st = trg.forward(tp, tc, x[:, :40], return_state=True)
    for t in range(40, 43):
        y, st = trg.decode_step(tp, tc, x[:, t:t + 1], st)
        np.testing.assert_allclose(np_of(y), np_of(whole[:, t:t + 1]),
                                   **LAYER_TOL)


def test_init_state_matches_the_reference():
    jc, tc = cfg_pair()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jrg.init_state(jc, 3, jdt)
        got = trg.init_state(tc, 3, tdt, device="cpu")
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[1] == str(want[key].dtype)
            assert not got[key].any()


# ----------------------------------------------------------------- bf16 --
def test_bf16_paths_follow_the_reference():
    """bf16 weights and inputs: the prefill (its conv cast to bf16) and a
    decode step (its conv left in float32) each follow the reference's
    own dtype steps."""
    jc, tc, jp, tp = block_pair(dtype=jnp.bfloat16)
    rng = np.random.default_rng(34)
    x = rng.normal(size=(2, 20, tc.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = t_of(x).to(torch.bfloat16)
    jy, jst = jrg.forward(jp, jc, jx, return_state=True)
    ty, tst = trg.forward(tp, tc, tx, return_state=True)
    assert ty.dtype == torch.bfloat16 and tst["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(ty), np_of(jy), **BF16_TOL)
    np.testing.assert_allclose(np_of(tst["h"]), np_of(jst["h"]), **BF16_TOL)
    xd = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    jy, jst = jrg.decode_step(jp, jc, jnp.asarray(xd).astype(jnp.bfloat16),
                              jst)
    ty, tst = trg.decode_step(tp, tc, t_of(xd).to(torch.bfloat16), tst)
    assert ty.dtype == torch.bfloat16 and tst["h"].dtype == torch.float32
    np.testing.assert_allclose(np_of(ty), np_of(jy), **BF16_TOL)
    np.testing.assert_allclose(np_of(tst["h"]), np_of(jst["h"]), **BF16_TOL)
    np.testing.assert_allclose(np_of(tst["conv"]), np_of(jst["conv"]),
                               **BF16_TOL)
