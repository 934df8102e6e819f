"""The port's ``fused`` path (``repro_torch.kernels.fused``) against the
JAX package's (``repro.kernels.fused``), on the CPU.

Inputs are numpy draws from stated seeds, fed to both. The cases are
``tests/test_fused.py``'s: its ``CASES`` at a key block of 64 (B 2, S
256, 4 query heads over 2 kv heads, d 32), its shape sweep at block 128,
bf16, and its decode and SSD cases, plus a non-``arange``
``segment_pos``, a key count no block divides, an SSD initial state and
a ragged L (the plain-scan fallback).

Tolerances, as stated here:

* attention forward ``atol = rtol = 2e-5`` against the JAX
  ``fused_attention`` and the port's ``flash_attention_ref`` (the
  reference's own float32 bound); bf16 the reference's ``5e-2``;
* attention gradients within ``1e-4`` x the largest |gradient| of each
  of dq, dk, dv against ``jax.grad`` of the JAX custom VJP, and
  ``atol = rtol = 1e-3`` against autograd through the port's plain
  version (the bound ``tests/test_fused.py`` holds the reference to);
* SSD y and final state ``atol = rtol = 5e-4`` against the plain scan
  (the reference's bound) and ``GRAD_REL`` x the largest value against
  the JAX ``fused_ssd_scan``; SSD gradients ``GRAD_REL`` x max too;
* logits of reduced StableLM-3B / Mamba2-370m / Gemma2-27B under
  ``kernels="fused"`` within ``atol = rtol = 1e-4`` (the model files'
  bound) of ``"ref"`` and of the JAX model under its ``"fused"`` impl.

The port masks the SSD's intra-chunk decay exponent before the ``exp``;
the reference masks after it, and its gradient is NaN wherever a chunk's
decay overflows float32 (reduced Mamba2-370m already). The last SSD case
shows the port's gradient finite there and equal to autograd through
the sequential plain scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.kernels import fused as jf
from repro.kernels import ops as jops
from repro.models import model as jm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels import _build, fused, ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.routing_score import (build_erlang_table,
                                               routing_score)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import model as tm

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
REF_GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
SSD_TOL = dict(atol=5e-4, rtol=5e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL = 1e-4

CASES = [dict(causal=True), dict(causal=True, window=64),
         dict(causal=True, softcap=20.0), dict(causal=False),
         dict(causal=True, window=100, softcap=30.0)]


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def assert_rel_to_max(got, want, rel=GRAD_REL, what=""):
    """|got - want| <= rel x max |want|, elementwise."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, what
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def qkv(b=2, s=256, h=4, hkv=2, d=32, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def args_of(kw):
    return (kw.get("causal", True), kw.get("window", 0),
            kw.get("softcap", 0.0))


def port_fused(q, k, v, kw, block, segment_pos=None):
    return fused.fused_attention(q, k, v, *args_of(kw), None, segment_pos,
                                 block)


def jax_fused(q, k, v, kw, block, segment_pos=None):
    return jf.fused_attention(q, k, v, *args_of(kw), None, segment_pos,
                              block)


def port_grads(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    return torch.autograd.grad(fn(*ts).square().sum(), ts)


def jax_grads(fn, *xs):
    return jax.grad(lambda *a: jnp.sum(jnp.square(fn(*a))),
                    argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))


class TestFusedAttention:
    @pytest.mark.parametrize("kw", CASES)
    def test_forward(self, kw):
        q, k, v = qkv()
        got = port_fused(*map(torch.from_numpy, (q, k, v)), kw, 64)
        np.testing.assert_allclose(np_of(got), jax_fused(q, k, v, kw, 64),
                                   **TOL)
        want = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
        np.testing.assert_allclose(np_of(got), np_of(want), **TOL)

    @pytest.mark.parametrize("kw", CASES)
    def test_grads_match_the_reference_vjp(self, kw):
        q, k, v = qkv(seed=1)
        got = port_grads(lambda *t: port_fused(*t, kw, 64), q, k, v)
        want = jax_grads(lambda *a: jax_fused(*a, kw, 64), q, k, v)
        for name, a, b in zip("qkv", got, want):
            assert_rel_to_max(a, b, what=f"d{name}")

    @pytest.mark.parametrize("kw", CASES)
    def test_grads_match_autograd_of_the_plain_version(self, kw):
        q, k, v = qkv(seed=1)
        got = port_grads(lambda *t: port_fused(*t, kw, 64), q, k, v)
        want = port_grads(lambda *t: ref.flash_attention_ref(*t, **kw),
                          q, k, v)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np_of(a), np_of(b), **REF_GRAD_TOL)

    @pytest.mark.parametrize("shapes", [(1, 128, 1, 1, 64),
                                        (2, 128, 8, 1, 16),
                                        (1, 512, 6, 3, 32)])
    def test_shape_sweep(self, shapes):
        b, s, h, hkv, d = shapes
        q, k, v = qkv(b, s, h, hkv, d, seed=2)
        kw = dict(causal=True)
        got = port_fused(*map(torch.from_numpy, (q, k, v)), kw, 128)
        np.testing.assert_allclose(np_of(got), jax_fused(q, k, v, kw, 128),
                                   **TOL)
        grads = port_grads(lambda *t: port_fused(*t, kw, 128), q, k, v)
        want = jax_grads(lambda *a: jax_fused(*a, kw, 128), q, k, v)
        for a, w in zip(grads, want):
            assert_rel_to_max(a, w)

    def test_bf16(self):
        q, k, v = qkv(seed=3)
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v))
        got = port_fused(tq, tk, tv, dict(causal=True), 64)
        assert got.dtype == torch.bfloat16
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        want = jax_fused(jq, jk, jv, dict(causal=True), 64)
        np.testing.assert_allclose(np_of(got), np.asarray(want, np.float32),
                                   **BF16_TOL)
        dq, dk, dv = torch.autograd.grad(
            port_fused(*(x.requires_grad_(True) for x in (tq, tk, tv)),
                       dict(causal=True), 64).float().square().sum(),
            (tq, tk, tv))
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16

    @pytest.mark.parametrize("kw", [dict(causal=True),
                                    dict(causal=True, window=48)])
    def test_segment_pos_not_arange(self, kw):
        """Queries at positions of their own (each row shifted, a gap in
        the middle) against 256 keys: masks read ``segment_pos``."""
        q, k, v = qkv(s=128, skv=256, seed=4)
        base = np.concatenate([np.arange(64), np.arange(64) + 150])
        pos = np.stack([base, base + 20]).astype(np.int32)
        got = port_fused(*map(torch.from_numpy, (q, k, v)), kw, 64,
                         torch.from_numpy(pos))
        np.testing.assert_allclose(
            np_of(got), jax_fused(q, k, v, kw, 64, jnp.asarray(pos)), **TOL)
        want = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       segment_pos=torch.from_numpy(pos),
                                       **kw)
        np.testing.assert_allclose(np_of(got), np_of(want), **TOL)
        grads = port_grads(lambda *t: port_fused(
            *t, kw, 64, torch.from_numpy(pos)), q, k, v)
        jgrads = jax_grads(lambda *a: jax_fused(*a, kw, 64,
                                                jnp.asarray(pos)), q, k, v)
        for a, w in zip(grads, jgrads):
            assert_rel_to_max(a, w)

    def test_key_count_no_block_divides_raises(self):
        """Skv 200 with block 64: the reference's reshape fails; the port
        says why instead of padding."""
        q, k, v = qkv(s=200, seed=5)
        with pytest.raises(ValueError, match="multiple of the key block"):
            port_fused(*map(torch.from_numpy, (q, k, v)), {}, 64)
        with pytest.raises(ValueError, match="cannot reshape"):
            jax_fused(q, k, v, {}, 64)
        # a block at least Skv is one block
        got = port_fused(*map(torch.from_numpy, (q, k, v)), {}, 512)
        np.testing.assert_allclose(np_of(got), jax_fused(q, k, v, {}, 512),
                                   **TOL)


class TestFusedDecode:
    @pytest.mark.parametrize("kw", [dict(), dict(window=128),
                                    dict(softcap=50.0)])
    def test_matches_the_reference(self, kw):
        rng = np.random.default_rng(6)
        b, h, hkv, d, c = 3, 4, 2, 32, 256
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        kc = rng.standard_normal((b, c, hkv, d)).astype(np.float32)
        vc = rng.standard_normal((b, c, hkv, d)).astype(np.float32)
        kv_pos = rng.integers(-1, 300, (b, c)).astype(np.int32)
        q_pos = rng.integers(100, 301, (b,)).astype(np.int32)
        t = [torch.from_numpy(x) for x in (q, kc, vc, kv_pos, q_pos)]
        got = fused.fused_decode_attention(*t, **kw)
        np.testing.assert_allclose(
            np_of(got), jf.fused_decode_attention(q, kc, vc, kv_pos, q_pos,
                                                  **kw), **TOL)
        np.testing.assert_allclose(
            np_of(got), np_of(ref.decode_attention_ref(*t, **kw)), **TOL)


def ssd_inputs(b=2, l=128, h=4, p=32, g=2, n=16, seed=7, h0=False,
               dt_shift=0.0):
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.standard_normal((b, l, h, p)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, l, h)) + dt_shift))
        .astype(np.float32),
        a=-np.exp(rng.standard_normal(h) * 0.5).astype(np.float32),
        b=(rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
        c=(rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
        d_skip=rng.standard_normal(h).astype(np.float32))
    if h0:
        out["initial_state"] = (rng.standard_normal((b, h, p, n)) * 0.5) \
            .astype(np.float32)
    return out


SSD_ARGS = ("x", "dt", "a", "b", "c", "d_skip")


def port_ssd(inp, chunk, **kw):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return fused.fused_ssd_scan(*(t[k] for k in SSD_ARGS),
                                initial_state=t.get("initial_state"),
                                return_final_state=True, chunk=chunk, **kw)


def jax_ssd(inp, chunk):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return jf.fused_ssd_scan(*(j[k] for k in SSD_ARGS),
                             initial_state=j.get("initial_state"),
                             return_final_state=True, chunk=chunk)


def plain_ssd(inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return ref.ssd_scan_ref(*(t[k] for k in SSD_ARGS),
                            initial_state=t.get("initial_state"),
                            return_final_state=True)


class TestFusedSSD:
    @pytest.mark.parametrize("h0", [False, True])
    @pytest.mark.parametrize("chunk", [16, 32, 64])
    def test_matches_the_reference(self, chunk, h0):
        inp = ssd_inputs(h0=h0)
        y, hf = port_ssd(inp, chunk)
        jy, jh = jax_ssd(inp, chunk)
        assert_rel_to_max(y, jy, what="y")
        assert_rel_to_max(hf, jh, what="final state")
        py, ph = plain_ssd(inp)
        np.testing.assert_allclose(np_of(y), np_of(py), **SSD_TOL)
        np.testing.assert_allclose(np_of(hf), np_of(ph), **SSD_TOL)

    def test_ragged_length_runs_the_plain_scan(self):
        inp = ssd_inputs(l=100, h0=True, seed=8)
        y, hf = port_ssd(inp, 64)
        py, ph = plain_ssd(inp)
        assert torch.equal(y, py) and torch.equal(hf, ph)
        jy, jh = jax_ssd(inp, 64)
        np.testing.assert_allclose(np_of(y), np.asarray(jy), **SSD_TOL)
        np.testing.assert_allclose(np_of(hf), np.asarray(jh), **SSD_TOL)

    @pytest.mark.parametrize("chunk", [16, 64])
    def test_grads_match_the_reference(self, chunk):
        inp = ssd_inputs(b=1, l=64, h=2, p=16, g=1, n=8, seed=9, h0=True)
        names = SSD_ARGS + ("initial_state",)

        def port_loss(*ts):
            y, hf = fused.fused_ssd_scan(*ts[:6], initial_state=ts[6],
                                         return_final_state=True,
                                         chunk=chunk)
            return torch.cat([y.reshape(-1), hf.reshape(-1)])

        def jax_loss(*js):
            y, hf = jf.fused_ssd_scan(*js[:6], initial_state=js[6],
                                      return_final_state=True, chunk=chunk)
            return jnp.concatenate([y.reshape(-1), hf.reshape(-1)])

        got = port_grads(port_loss, *(inp[k] for k in names))
        want = jax_grads(jax_loss, *(inp[k] for k in names))
        for name, a, w in zip(names, got, want):
            assert_rel_to_max(a, w, what=f"d{name}")

    def test_grads_finite_where_a_chunks_decay_overflows(self):
        """dt ~ softplus(N(4, 1)) and a ~ -1: a chunk of 64 decays by
        ~e^-280, past float32's range. The reference's fused gradient in
        dt is NaN here; the port's equals autograd through the plain
        scan."""
        inp = ssd_inputs(b=1, l=64, h=2, p=16, g=1, n=8, seed=10,
                         dt_shift=4.0)
        rest = [inp[k] for k in SSD_ARGS[2:]]
        jgdt = jax.grad(lambda dt: jnp.sum(jnp.square(jf.fused_ssd_scan(
            jnp.asarray(inp["x"]), dt, *map(jnp.asarray, rest),
            chunk=64))))(jnp.asarray(inp["dt"]))
        assert not bool(jnp.isfinite(jgdt).all())
        x = torch.from_numpy(inp["x"])
        got = port_grads(lambda dt: fused.fused_ssd_scan(
            x, dt, *map(torch.from_numpy, rest), chunk=64), inp["dt"])[0]
        want = port_grads(lambda dt: ref.ssd_scan_ref(
            x, dt, *map(torch.from_numpy, rest)), inp["dt"])[0]
        assert bool(torch.isfinite(got).all())
        assert_rel_to_max(got, want)


def routing_inputs(seed=12, r=64, i=6):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(5, 20, i).astype(np.float32)
    n = rng.integers(1, 4, i).astype(np.float32)
    cols = dict(
        lam=rng.uniform(0, 40, r).astype(np.float32),
        alpha=rng.uniform(0.01, 0.05, i).astype(np.float32),
        beta=rng.uniform(0.001, 0.01, i).astype(np.float32),
        gamma=rng.uniform(0.8, 1.5, i).astype(np.float32), mu=mu, n=n,
        rtt=rng.uniform(0, 0.05, i).astype(np.float32),
        slo=np.full(i, 0.5, np.float32),
        cost=rng.uniform(1, 3, i).astype(np.float32))
    out = {k: torch.from_numpy(v) for k, v in cols.items()}
    out["erlang_c_table"] = torch.from_numpy(
        np.asarray(build_erlang_table(mu, n), np.float32))
    return out


class TestOpsDispatch:
    def test_attention_ops_route_fused(self):
        q, k, v = (torch.from_numpy(x) for x in qkv(seed=13))
        got = ops.attention(q, k, v, causal=True, window=64, impl="fused")
        assert torch.equal(got, fused.fused_attention(q, k, v, True, 64))
        np.testing.assert_allclose(
            np_of(got), np_of(ops.attention(q, k, v, causal=True, window=64,
                                            impl="ref")), **TOL)
        rng = np.random.default_rng(14)
        kv_pos = torch.from_numpy(rng.integers(-1, 256, (2, 256))
                                  .astype(np.int32))
        q_pos = torch.tensor([200, 255], dtype=torch.int32)
        got = ops.decode_attention(q[:, 0], k, v, kv_pos, q_pos,
                                   impl="fused")
        np.testing.assert_allclose(
            np_of(got), np_of(ops.decode_attention(q[:, 0], k, v, kv_pos,
                                                   q_pos, impl="ref")),
            **TOL)

    def test_ssd_op_routes_fused_with_its_chunk(self):
        inp = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=15).items()}
        args = [inp[k] for k in SSD_ARGS]
        got = ops.ssd_scan(*args, impl="fused", chunk=32)
        assert torch.equal(got, fused.fused_ssd_scan(*args, chunk=32))
        np.testing.assert_allclose(
            np_of(got), np_of(ops.ssd_scan(*args, impl="ref")), **SSD_TOL)

    def test_routing_ops_under_fused_are_the_plain_versions(self):
        cols = routing_inputs()
        score = [cols[k] for k in ("lam", "alpha", "beta", "gamma", "mu",
                                   "n", "rtt", "slo", "cost",
                                   "erlang_c_table")]
        for got, want in zip(ops.routing_score(*score, impl="fused"),
                             ops.routing_score(*score, impl="ref")):
            assert torch.equal(got, want)
        for got, want in zip(ops.routing_topk(*score, k=2, impl="fused"),
                             ops.routing_topk(*score, k=2, impl="ref")):
            assert torch.equal(got, want)
        i = cols["mu"].shape[0]
        sigma, avail = torch.full((i,), 0.3), torch.full((i,), 0.99)
        attain = score[:8] + [sigma, avail, cols["erlang_c_table"]]
        for got, want in zip(ops.routing_attain(*attain, impl="fused"),
                             ops.routing_attain(*attain, impl="ref")):
            assert torch.equal(got, want)
        r = cols["lam"].shape[0]
        guard = score[:7] + [torch.full((r,), 0.2),
                             torch.zeros(r, dtype=torch.int32),
                             torch.ones(r, dtype=torch.int32),
                             cols["erlang_c_table"]]
        for got, want in zip(ops.routing_guard(*guard, impl="fused"),
                             ops.routing_guard(*guard, impl="ref")):
            assert torch.equal(got, want)

    def test_unknown_impl_raises(self):
        q, k, v = (torch.from_numpy(x) for x in qkv(s=64, seed=16))
        with pytest.raises(ValueError, match="impl must be one of"):
            ops.attention(q, k, v, impl="pallas")


class TestWrappersRefuseGradients:
    """A hand-kernel wrapper never returns a result cut from the graph:
    with grad mode on and an input that requires grad it raises (on the
    CPU too, where it would run the plain version); without either it
    runs."""

    def test_attention_wrappers(self):
        q, k, v = (torch.from_numpy(x) for x in qkv(s=64, seed=17))
        kq = k.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, kq, v)
        kv_pos = torch.arange(64, dtype=torch.int32)[None].expand(2, 64) \
            .contiguous()
        q_pos = torch.full((2,), 63, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="kernels='fused' or 'ref'"):
            decode_attention(q[:, 0].clone().requires_grad_(True), k, v,
                             kv_pos, q_pos)
        with torch.no_grad():
            out = flash_attention(q, kq, v)
        assert not out.requires_grad
        assert torch.equal(flash_attention(q, k, v),
                           ref.flash_attention_ref(q, k, v))

    def test_ssd_and_routing_wrappers(self):
        inp = {k: torch.from_numpy(v) for k, v in ssd_inputs(seed=18).items()}
        args = [inp[k] for k in SSD_ARGS]
        args[1] = args[1].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="ssd_scan"):
            ssd_scan(*args)
        with torch.inference_mode():
            ssd_scan(*args)
        cols = routing_inputs()
        cols["lam"].requires_grad_(True)
        with pytest.raises(RuntimeError, match="routing_score"):
            routing_score(*(cols[k] for k in (
                "lam", "alpha", "beta", "gamma", "mu", "n", "rtt", "slo",
                "cost", "erlang_c_table")))

    def test_refusal_reads_grad_mode(self):
        x = torch.ones(3, requires_grad=True)
        with pytest.raises(RuntimeError):
            _build.refuse_grad("op", None, x)
        with torch.no_grad():
            _build.refuse_grad("op", None, x)
        _build.refuse_grad("op", torch.ones(3), 1.0)


MODELS = [("stablelm_3b", 64), ("mamba2_370m", 64), ("gemma2_27b", 64)]


@pytest.mark.parametrize("arch,seq", MODELS)
def test_model_logits_under_fused(arch, seq):
    """Reduced models (reference weights from PRNGKey(0)): the port's
    logits under ``kernels="fused"`` against its ``"ref"`` and against the
    JAX model under its ``"fused"`` impl (restored in ``finally``)."""
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    tokens = np.random.default_rng(19).integers(
        0, tc.vocab_size, (2, seq)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    got, _ = tm.forward(tp, tc, batch, kernels="fused")
    want, _ = tm.forward(tp, tc, batch, kernels="ref")
    np.testing.assert_allclose(np_of(got), np_of(want), **LOGIT_TOL)
    old = jops.get_implementation()
    try:
        jops.set_implementation("fused")
        jwant, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    finally:
        jops.set_implementation(old)
    np.testing.assert_allclose(np_of(got), np.asarray(jwant), **LOGIT_TOL)
