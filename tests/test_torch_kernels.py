"""The port's routing kernels: plain versions against the JAX package,
the dispatch facade, and (on a card) the CUDA kernels.

Here on the CPU the port's plain ``routing_score_ref``,
``routing_guard_ref``, ``routing_topk_ref`` and ``routing_attain_ref``
are held

* against ``repro.kernels.ref`` (the same pow / lerp arithmetic, run
  jitted through ``repro.kernels.ops`` with ``impl="ref"``):
  decisions exact, g within ``rtol=2e-6`` (twice the measured 1.07e-6
  XLA-vs-torch exp/log gap);
* against the Pallas kernels in interpret mode (exp/log and hat-function
  arithmetic, as ``tests/test_kernels_smoke.py`` runs them): ``ok`` /
  ``offloaded`` exact, ``idx`` on feasible rows, g within ``rtol=1e-4``
  — the reference's own kernel-vs-oracle bound.

The top-k cases are every case of the reference's ``TestRoutingTopK``
and ``TestRoutingAttain`` (``tests/test_kernels.py``), same seeds, plus
per-request SLO rows with -1 lane exclusions. Phi is ``torch.erf``
against XLA's ``erf``: a few ulp apart, which moves no decision here.

The attention cases (at the end) hold ``flash_attention_ref`` and
``decode_attention_ref`` to ``repro.kernels.ref.attention`` and
``decode_attention`` on every case of the reference's
``TestFlashAttention`` and ``TestDecodeAttention`` (numpy inputs from
the same seeds), plus head_dim 80 (StableLM-3B), a 200-token sequence
(not a multiple of any tile) and a row with no valid cache slot, within
the reference's own bounds: ``2e-5`` in float32, ``5e-2`` in bfloat16.

The SSD cases (last) hold ``ssd_scan_ref`` to the reference's
sequential oracle ``repro.kernels.ref.ssd_scan`` on the shapes of the
reference's ``TestSSDScan`` (numpy inputs from stated seeds), its
half-and-half initial-state continuation, L = 1, 100 and 200 (no chunk
divides them), a long-memory case whose state survives every chunk, and
bfloat16 inputs, at ``2e-5`` (float32; y in bfloat16 within one bf16
step), and one case against the Pallas kernel in interpret mode at the
reference's own ``5e-4``. A plain emulation of the bf16 kernel body's
arithmetic (hi/lo bf16 parts of its float32 operands) is held to the
plain version at ``MODEL_BF16_TOL``.

Tests marked ``cuda`` run the hand-written kernels against the plain
versions and skip without a card (``python3 chip_smoke.py`` runs the
same checks there at full width).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash_attention
from repro.kernels.routing_decide import routing_attain as pallas_attain
from repro.kernels.routing_decide import routing_guard as pallas_guard
from repro.kernels.routing_decide import routing_topk as pallas_topk
from repro.kernels.routing_score import build_erlang_table as j_table
from repro.kernels.routing_score import routing_score as pallas_score
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import routing_decide as trd
from repro_torch.kernels import routing_score as trs
from repro_torch.kernels import ssd_scan as tss

SWEEP = [(2, 64), (6, 256), (11, 128)]


def setup(i: int, r: int, seed: int) -> tuple:
    """The reference kernel tests' seeded candidate table + rates."""
    rng = np.random.default_rng(seed)
    p = dict(
        alpha=rng.uniform(0.1, 1.0, i).astype(np.float32),
        beta=rng.uniform(0.1, 2.0, i).astype(np.float32),
        gamma=rng.uniform(0.9, 1.8, i).astype(np.float32),
        mu=rng.uniform(0.5, 3.0, i).astype(np.float32),
        n=rng.integers(1, 8, i).astype(np.float32),
        rtt=rng.uniform(0, 0.1, i).astype(np.float32),
    )
    lam = rng.uniform(0.0, 10.0, r).astype(np.float32)
    table = trs.build_erlang_table(p["mu"], p["n"])
    return rng, lam, p, table


def score_inputs(i, r, seed, slo_rows=False):
    rng, lam, p, table = setup(i, r, seed)
    p["slo"] = rng.uniform(1.0, 4.0, i).astype(np.float32)
    p["cost"] = rng.uniform(1, 3, i).astype(np.float32)
    if slo_rows:
        rng2 = np.random.default_rng(seed)
        rows = rng2.uniform(0.5, 4.0, (r, i)).astype(np.float32)
        rows[rng2.uniform(size=(r, i)) < 0.2] = -1.0
        p["slo"] = rows
    return [lam] + list(p.values()) + [table]


def guard_inputs(i, r, seed):
    rng, lam, p, table = setup(i, r, seed)
    tau = rng.uniform(0.1, 3.0, r).astype(np.float32)
    home = rng.integers(0, i, r).astype(np.int32)
    up = rng.integers(-1, i, r).astype(np.int32)
    return [lam] + list(p.values()) + [tau, home, up, table]


def as_torch(args, device="cpu"):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in args]


def as_jax(args):
    return [jnp.asarray(a) for a in args]


def np_out(outs):
    return [np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o)
            for o in outs]


def check_score(got, want, g_rtol):
    gi, gg, gok = got
    wi, wg, wok = want
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi[wok], wi[wok])
    np.testing.assert_allclose(gg[wok], wg[wok], rtol=g_rtol)


def check_guard(got, want, g_rtol):
    gi, gg, goff = got
    wi, wg, woff = want
    np.testing.assert_array_equal(goff, woff)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gg, wg, rtol=g_rtol)


class TestPlainAgainstJaxOracle:
    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_score(self, i, r):
        args = score_inputs(i, r, seed=i)
        got = np_out(tref.routing_score_ref(*as_torch(args)))
        want = np_out(jops.routing_score(*as_jax(args), impl="ref"))
        np.testing.assert_array_equal(got[0], want[0])   # every row
        check_score(got, want, 2e-6)

    @pytest.mark.parametrize("i,r", [(3, 64), (6, 128)])
    def test_routing_score_slo_rows(self, i, r):
        args = score_inputs(i, r, seed=100 + i, slo_rows=True)
        got = np_out(tref.routing_score_ref(*as_torch(args)))
        want = np_out(jops.routing_score(*as_jax(args), impl="ref"))
        assert want[2].any() and not want[2].all()   # both regimes
        np.testing.assert_array_equal(got[0], want[0])
        check_score(got, want, 2e-6)

    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_guard(self, i, r):
        args = guard_inputs(i, r, seed=20 + i)
        got = np_out(tref.routing_guard_ref(*as_torch(args)))
        want = np_out(jops.routing_guard(*as_jax(args), impl="ref"))
        check_guard(got, want, 2e-6)

    def test_per_candidate_rates(self):
        """(R, I) rates — the admission-window form the policies use."""
        args = score_inputs(4, 64, seed=3)
        rng = np.random.default_rng(3)
        args[0] = rng.uniform(0.0, 10.0, (64, 4)).astype(np.float32)
        check_score(np_out(tref.routing_score_ref(*as_torch(args))),
                    np_out(jops.routing_score(*as_jax(args), impl="ref")), 2e-6)
        gargs = guard_inputs(4, 64, seed=24)
        gargs[0] = args[0]
        check_guard(np_out(tref.routing_guard_ref(*as_torch(gargs))),
                    np_out(jops.routing_guard(*as_jax(gargs), impl="ref")), 2e-6)


class TestPlainSemantics:
    def test_per_request_rows_match_shared_slo(self):
        """Broadcasting the shared (I,) budget into identical (R, I) rows
        changes no decision."""
        args = as_torch(score_inputs(4, 64, seed=3))
        shared = np_out(tref.routing_score_ref(*args))
        args[7] = args[7][None, :].expand(64, 4).contiguous()
        rows = np_out(tref.routing_score_ref(*args))
        for a, b in zip(shared, rows):
            np.testing.assert_array_equal(a, b)

    def test_matches_router_scalar_path(self):
        """The plain version agrees with the port's numpy scorer (the
        simulator's) up to the table-interpolation error."""
        from repro_torch.core.router import score_instances_np
        args = score_inputs(4, 64, seed=7)
        lam, alpha, beta, gamma, mu, n, rtt, slo = args[:8]
        _, rg, rok = np_out(tref.routing_score_ref(*as_torch(args)))
        checked = 0
        for r in range(0, 64, 7):
            g_np = score_instances_np(float(lam[r]), alpha, beta, gamma, mu,
                                      n, rtt)
            feasible = (g_np <= slo) & (g_np < 1e8)
            if feasible.any() and rok[r]:
                best = g_np[feasible].min()
                assert abs(float(rg[r]) - best) / best < 0.05
                checked += 1
        assert checked


class TestPlainAgainstPallasInterpret:
    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_score(self, i, r):
        args = score_inputs(i, r, seed=i)
        got = np_out(tref.routing_score_ref(*as_torch(args)))
        want = np_out(pallas_score(*as_jax(args), block_r=64,
                                   interpret=True))
        check_score(got, want, 1e-4)

    @pytest.mark.parametrize("i,r", [(3, 64), (6, 128)])
    def test_routing_score_slo_rows(self, i, r):
        args = score_inputs(i, r, seed=100 + i, slo_rows=True)
        got = np_out(tref.routing_score_ref(*as_torch(args)))
        want = np_out(pallas_score(*as_jax(args), block_r=32,
                                   interpret=True))
        check_score(got, want, 1e-4)

    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_guard(self, i, r):
        args = guard_inputs(i, r, seed=20 + i)
        got = np_out(tref.routing_guard_ref(*as_torch(args)))
        want = np_out(pallas_guard(*as_jax(args), block_r=64,
                                   interpret=True))
        check_guard(got, want, 1e-4)


def tau_boundary_inputs():
    i, r = 3, 8
    args = guard_inputs(i, r, seed=5)
    args[0] = np.zeros(r, np.float32)
    home = (np.arange(r) % i).astype(np.int32)
    up = ((np.arange(r) + 1) % i).astype(np.int32)
    alpha, rtt = args[1], args[6]
    g_inst = alpha[home] + rtt[home] - rtt[home]
    args[8], args[9] = home, up
    return args, g_inst


def guard_stage_inputs(i, seed, lam_rows=True, tau_edges=False, r=300):
    """``routing_guard`` inputs around the kernel's staging cap: (R, I)
    or (R,) rates, every seventh row at the top tier (up = -1). With
    ``tau_edges`` ((R, I) rates), a zero rate at each row's home column
    makes g_home = alpha + rtt exactly, and tau is g_inst on even rows
    (strict >: held) and one ulp below on odd ones (offloaded where up
    >= 0). Returns (args, pinned offloaded or None)."""
    args = guard_inputs(i, r, seed)
    if lam_rows:
        args[0] = np.random.default_rng(seed + 1).uniform(
            0.0, 10.0, (r, i)).astype(np.float32)
    home, up = args[8], args[9]
    up[::7] = -1
    if not tau_edges:
        return args, None
    args[0][np.arange(r), home] = 0.0
    alpha, rtt = args[1], args[6]
    g_inst = alpha[home] + rtt[home] - rtt[home]
    odd = np.arange(r) % 2 == 1
    args[7] = np.where(odd, np.nextafter(g_inst, np.float32(-1.0)),
                       g_inst).astype(np.float32)
    return args, odd & (up >= 0)


class TestGuardEdges:
    """The reference's pinned guard edges (tests/test_kernels.py)."""

    @pytest.mark.parametrize("i", [trd.GUARD_STAGE_MAX,
                                   trd.GUARD_STAGE_MAX + 1])
    def test_tau_edges_at_the_staging_cap(self, i):
        """The pinned tau == g_inst edges with top-tier rows on both
        sides of the CUDA kernel's staging cap (its card test's inputs):
        the plain version and the JAX oracle offload exactly the pinned
        rows."""
        args, want = guard_stage_inputs(i, 5100 + i, tau_edges=True)
        gi, _, off = np_out(tref.routing_guard_ref(*as_torch(args)))
        np.testing.assert_array_equal(off, want)
        wi, _, woff = np_out(jops.routing_guard(*as_jax(args), impl="ref"))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(off, woff)

    @pytest.mark.parametrize("below,want_off", [(False, False),
                                                (True, True)])
    def test_tau_boundary_is_strict(self, below, want_off):
        """lam = 0 makes g = alpha + rtt exactly, so the boundary pins
        bitwise: tau == g_inst must NOT offload, one ulp below must."""
        args, g_inst = tau_boundary_inputs()
        tau = np.nextafter(g_inst, np.float32(-1.0)) if below else g_inst
        args[7] = tau.astype(np.float32)
        for impl in (tref.routing_guard_ref, trd.routing_guard):
            gi, _, off = np_out(impl(*as_torch(args)))
            assert (off == want_off).all()
            wi, _, woff = np_out(jops.routing_guard(*as_jax(args), impl="ref"))
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(off, woff)

    def test_top_tier_and_unstable_sentinel(self):
        r = 8
        p = [np.asarray(v, np.float32) for v in (
            [0.1, 0.1], [0.1, 0.1], [1.0, 1.0], [0.01, 100.0], [1.0, 1.0],
            [0.01, 0.02])]
        table = trs.build_erlang_table(p[3], p[4])
        args = [np.full(r, 5.0, np.float32)] + p + [
            np.asarray([0.5, 0.5, 1e9, 1e9] * (r // 4), np.float32),
            np.zeros(r, np.int32),
            np.asarray([1, -1] * (r // 2), np.int32), table]
        gi, gg, off = np_out(tref.routing_guard_ref(*as_torch(args)))
        want = np.array([True, False, False, False] * (r // 4))
        np.testing.assert_array_equal(off, want)
        wi, wg, woff = np_out(jops.routing_guard(*as_jax(args), impl="ref"))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(off, woff)
        # the stayed-home rows report the sentinel, not a finite g
        assert float(gg[1]) == 1e9 == float(wg[1])


class TestErlangTable:
    @pytest.mark.parametrize("seed,i,t", [(0, 3, 65), (1, 8, 33),
                                          (2, 16, 65)])
    def test_bitwise_equal_to_reference(self, seed, i, t):
        rng = np.random.default_rng(seed)
        mu = rng.uniform(0.3, 3.0, i)
        n = rng.integers(1, 9, i)
        got = trs.build_erlang_table(mu, n, t=t)
        want = np.asarray(j_table(mu, n, t=t))
        assert got.dtype == np.float32 and got.shape == (i, t)
        np.testing.assert_array_equal(got, want)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        args = as_torch(score_inputs(3, 16, seed=3))
        before = trs.routing_score.launches
        got = np_out(trs.routing_score(*args))
        assert trs.routing_score.launches == before   # nothing launched
        for a, b in zip(got, np_out(tref.routing_score_ref(*args))):
            np.testing.assert_array_equal(a, b)
        gargs = as_torch(guard_inputs(3, 16, seed=4))
        before = trd.routing_guard.launches
        got = np_out(trd.routing_guard(*gargs))
        assert trd.routing_guard.launches == before
        for a, b in zip(got, np_out(tref.routing_guard_ref(*gargs))):
            np.testing.assert_array_equal(a, b)

    def test_facade_cuda_impl_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            ops.routing_score(*as_torch(score_inputs(3, 16, seed=3)),
                              impl="cuda")
        with pytest.raises(ValueError, match="CUDA"):
            ops.routing_guard(*as_torch(guard_inputs(3, 16, seed=4)),
                              impl="cuda")
        with pytest.raises(ValueError, match="impl"):
            ops.routing_score(*as_torch(score_inputs(3, 16, seed=3)),
                              impl="pallas")

    def test_facade_ref_is_the_plain_version(self):
        args = as_torch(score_inputs(6, 32, seed=6))
        for a, b in zip(np_out(ops.routing_score(*args, impl="ref")),
                        np_out(tref.routing_score_ref(*args))):
            np.testing.assert_array_equal(a, b)

    def test_policy_cuda_backend_on_cpu_raises(self):
        from repro_torch.control.admission import AdmissionConfig
        from repro_torch.control.policies import make_policy
        from repro_torch.core.catalogue import paper_cluster
        from repro_torch.core.router import Router
        cl = paper_cluster()
        for name in ("route_best", "guarded_alg1", "safetail", "reliable",
                     "hybrid"):
            with pytest.raises(ValueError, match="cuda"):
                make_policy(name, cl, Router(cl, device="cpu"),
                            AdmissionConfig(backend="cuda", device="cpu"))
        with pytest.raises(ValueError, match="backend"):
            make_policy("route_best", cl, Router(cl, device="cpu"),
                        AdmissionConfig(backend="pallas", device="cpu"))

    def test_missing_nvcc_raises_at_first_launch_only(self, monkeypatch,
                                                      tmp_path):
        from repro_torch.kernels import _build
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()


def topk_inputs(i, r, seed, slo_rows=False, lam_rows=False):
    """``routing_topk`` inputs: the reference's ``TestRoutingTopK``
    draws (``_routing_setup`` + slo + cost), optionally with (R, I)
    SLO rows carrying 20% lane exclusions and (R, I) rates."""
    rng, lam, p, table = setup(i, r, seed)
    p["slo"] = rng.uniform(1.0, 4.0, i).astype(np.float32)
    p["cost"] = rng.uniform(1, 3, i).astype(np.float32)
    if slo_rows:
        rows = rng.uniform(0.5, 4.0, (r, i)).astype(np.float32)
        rows[rng.uniform(size=(r, i)) < 0.2] = -1.0
        p["slo"] = rows
    if lam_rows:
        lam = rng.uniform(0.0, 10.0, (r, i)).astype(np.float32)
    return [lam] + list(p.values()) + [table]


def attain_inputs(i, r, seed, slo_rows=False, lam_rows=False):
    """``routing_attain`` inputs: the reference's ``TestRoutingAttain``
    draws (``_routing_setup`` + slo + sigma + avail)."""
    rng, lam, p, table = setup(i, r, seed)
    p["slo"] = rng.uniform(1.0, 4.0, i).astype(np.float32)
    p["sigma"] = rng.uniform(0.05, 0.8, i).astype(np.float32)
    p["avail"] = rng.uniform(0.7, 1.0, i).astype(np.float32)
    if slo_rows:
        rows = rng.uniform(0.5, 4.0, (r, i)).astype(np.float32)
        rows[rng.uniform(size=(r, i)) < 0.2] = -1.0
        p["slo"] = rows
    if lam_rows:
        lam = rng.uniform(0.0, 10.0, (r, i)).astype(np.float32)
    return [lam] + list(p.values()) + [table]


def edge_case(name: str):
    """The reference's pinned top-k / attainment edge cases, as
    (op, inputs, k, margin)."""
    if name == "topk_all_infeasible":
        rng, lam, p, table = setup(4, 32, seed=9)
        slo = np.full(4, 1e-6, np.float32)          # nothing meets this
        cost = rng.uniform(1, 3, 4).astype(np.float32)
        return "topk", [lam, *p.values(), slo, cost, table], 3, 0.0
    if name == "topk_k_exceeds_feasible":
        rng, lam, p, table = setup(5, 32, seed=13)
        cost = rng.uniform(1, 3, 5).astype(np.float32)
        rows = np.full((32, 5), -1.0, np.float32)
        rows[:, 1] = rows[:, 3] = 100.0             # cols 1 and 3 feasible
        return "topk", [lam, *p.values(), rows, cost, table], 5, 0.0
    if name.startswith("topk_clones") or name.startswith("attain_clones"):
        i, r = 4, 32
        one = lambda v: np.full(i, v, np.float32)
        cols = [one(0.2), one(0.3), one(1.2), one(2.0), one(2.0), one(0.01)]
        table = trs.build_erlang_table(cols[3], cols[4])
        lam = np.linspace(0.0, 3.0, r).astype(np.float32)
        if name.startswith("topk"):
            return "topk", [lam] + cols + [
                one(5.0), np.asarray([2.0, 1.0, 1.0, 2.0], np.float32),
                table], 4, 0.0
        return "attain", [lam] + cols + [one(5.0), one(0.3), one(1.0),
                                          table], 4, 0.0
    if name == "attain_sigma_zero":
        args = attain_inputs(4, 64, seed=91)
        args[8] = np.zeros(4, np.float32)
        args[9] = np.asarray([0.9, 0.99, 0.99, 0.7], np.float32)
        return "attain", args, 2, 0.0
    if name == "attain_uniform":
        args = attain_inputs(5, 64, seed=88)
        args[7] = np.full(5, 3.0, np.float32)
        args[8] = np.full(5, 0.3, np.float32)
        args[9] = np.full(5, 1.0, np.float32)
        return "attain", args, 2, 0.0
    if name == "attain_all_infeasible":
        args = attain_inputs(3, 32, seed=17)
        args[7] = np.full(3, 1e-6, np.float32)
        args[8] = np.full(3, 0.2, np.float32)
        args[9] = np.ones(3, np.float32)
        return "attain", args, 2, 0.0
    raise KeyError(name)


EDGE_CASES = ["topk_all_infeasible", "topk_k_exceeds_feasible",
              "topk_clones", "attain_clones", "attain_sigma_zero",
              "attain_uniform", "attain_all_infeasible"]
TOPK_PLAIN = {"topk": tref.routing_topk_ref, "attain": tref.routing_attain_ref}
TOPK_JAX = {"topk": jops.routing_topk, "attain": jops.routing_attain}
TOPK_PALLAS = {"topk": pallas_topk, "attain": pallas_attain}


def check_topk(got, want, g_rtol, exact=False):
    """``ok`` exact, ``idx`` on feasible rows (every row when ``exact``:
    infeasible rows are -1 throughout in both), g within ``g_rtol``."""
    gi, gg, gok = got
    wi, wg, wok = want
    np.testing.assert_array_equal(gok, wok)
    rows = slice(None) if exact else wok
    np.testing.assert_array_equal(gi[rows], wi[rows])
    np.testing.assert_allclose(gg[rows], wg[rows], rtol=g_rtol)


class TestTopKPlainAgainstJax:
    """routing_topk_ref / routing_attain_ref against the JAX oracle
    (decisions exact, g ``rtol=2e-6``) and against the Pallas kernels in
    interpret mode (``ok`` exact, ``idx`` on feasible rows, g
    ``rtol=1e-4``)."""

    @staticmethod
    def both(op, args, k, margin):
        got = np_out(TOPK_PLAIN[op](*as_torch(args), k=k, margin=margin))
        want = np_out(TOPK_JAX[op](*as_jax(args), k=k, margin=margin,
                                   impl="ref"))
        check_topk(got, want, 2e-6, exact=True)
        interp = np_out(TOPK_PALLAS[op](*as_jax(args), k=k, margin=margin,
                                        block_r=32, interpret=True))
        check_topk(got, interp, 1e-4)
        return got

    @pytest.mark.parametrize("i,r", SWEEP)
    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_topk_sweep(self, i, r, k):
        self.both("topk", topk_inputs(i, r, seed=40 + i), k, 0.0)

    @pytest.mark.parametrize("i,r", SWEEP)
    @pytest.mark.parametrize("k", [1, 3])
    def test_attain_sweep(self, i, r, k):
        self.both("attain", attain_inputs(i, r, seed=60 + i), k, 0.1)

    @pytest.mark.parametrize("margin", [0.0, 0.5, 2.0])
    def test_topk_margin_gates_duplicates(self, margin):
        self.both("topk", topk_inputs(5, 64, seed=77), 3, margin)

    @pytest.mark.parametrize("op,i,r", [("topk", 3, 64), ("topk", 6, 128),
                                        ("attain", 3, 64),
                                        ("attain", 6, 128)])
    def test_window_rows(self, op, i, r):
        """(R, I) rates and SLO rows with -1 lane exclusions, as the
        policies hand a window to the kernels."""
        make = topk_inputs if op == "topk" else attain_inputs
        args = make(i, r, seed=100 + i, slo_rows=True, lam_rows=True)
        got = self.both(op, args, 3, 0.25)
        assert got[2].any() and not got[2].all()     # both regimes

    @pytest.mark.parametrize("name", EDGE_CASES)
    def test_edge_case(self, name):
        op, args, k, margin = edge_case(name)
        gi, gg, gok = self.both(op, args, k, margin)
        if name.endswith("all_infeasible"):
            assert not gok.any() and (gi == -1).all()
        elif name == "topk_k_exceeds_feasible":
            assert gok.all() and set(gi[:, 0]) <= {1, 3}
            np.testing.assert_array_equal(gi[:, 2:], -1)
        elif name == "topk_clones":
            # cheapest near-tie (cost ties between cols 1/2 -> col 1),
            # then duplicates ascending by index
            for col, want in enumerate([1, 0, 2, 3]):
                np.testing.assert_array_equal(gi[:, col], want)


class TestTopKDispatch:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        for op, fn, args in (
                ("topk", trd.routing_topk, topk_inputs(4, 16, seed=1)),
                ("attain", trd.routing_attain, attain_inputs(4, 16, seed=2))):
            t = as_torch(args)
            before = fn.launches
            got = np_out(fn(*t, k=3, margin=0.1))
            assert fn.launches == before
            for a, b in zip(got, np_out(TOPK_PLAIN[op](*t, k=3,
                                                       margin=0.1))):
                np.testing.assert_array_equal(a, b)

    def test_facade(self):
        targs = as_torch(topk_inputs(3, 16, seed=3))
        aargs = as_torch(attain_inputs(3, 16, seed=3))
        for a, b in zip(np_out(ops.routing_topk(*targs, k=2, impl="ref")),
                        np_out(tref.routing_topk_ref(*targs, k=2))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(np_out(ops.routing_attain(*aargs, k=2, impl="ref")),
                        np_out(tref.routing_attain_ref(*aargs, k=2))):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="CUDA"):
            ops.routing_topk(*targs, impl="cuda")
        with pytest.raises(ValueError, match="CUDA"):
            ops.routing_attain(*aargs, impl="cuda")

    @pytest.mark.parametrize("fn,make", [
        (trd.routing_topk, topk_inputs), (trd.routing_attain, attain_inputs)])
    def test_k_outside_the_cap_raises(self, fn, make):
        """The kernels emit at most K_MAX columns; the wrapper holds a
        CPU caller to the same cap."""
        args = as_torch(make(3, 8, seed=4))
        assert fn(*args, k=trd.K_MAX)[0].shape == (8, trd.K_MAX)
        for k in (0, trd.K_MAX + 1):
            with pytest.raises(ValueError, match="outside"):
                fn(*args, k=k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have "
                    "no interpret mode (chip_smoke.py runs them on the "
                    "card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestCudaKernels:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_score_kernel(self, cuda_device, i, r):
        args = as_torch(score_inputs(i, r, seed=i), cuda_device)
        before = trs.routing_score.launches
        got = np_out(trs.routing_score(*args))
        assert trs.routing_score.launches == before + 1
        check_score(got, np_out(tref.routing_score_ref(*args)), 1e-4)

    @pytest.mark.parametrize("i,r", SWEEP)
    def test_routing_guard_kernel(self, cuda_device, i, r):
        args = as_torch(guard_inputs(i, r, seed=20 + i), cuda_device)
        before = trd.routing_guard.launches
        got = np_out(trd.routing_guard(*args))
        assert trd.routing_guard.launches == before + 1
        check_guard(got, np_out(tref.routing_guard_ref(*args)), 1e-4)

    @pytest.mark.parametrize("i,r", [(3, 64), (6, 128)])
    def test_routing_score_kernel_window_rows(self, cuda_device, i, r):
        """(R, I) rates and SLO rows with lane exclusions, as the
        policies hand a window to the kernel."""
        case = score_inputs(i, r, seed=100 + i, slo_rows=True)
        case[0] = np.random.default_rng(i).uniform(
            0.0, 10.0, (r, i)).astype(np.float32)
        args = as_torch(case, cuda_device)
        check_score(np_out(trs.routing_score(*args)),
                    np_out(tref.routing_score_ref(*args)), 1e-4)

    def test_kernel_rejects_wrong_dtype(self, cuda_device):
        args = as_torch(score_inputs(3, 16, seed=3), cuda_device)
        args[0] = args[0].double()
        with pytest.raises(TypeError):
            trs.routing_score(*args)


@pytest.mark.cuda
class TestCudaTopKKernels:
    """routing_topk / routing_attain kernels against their plain
    versions on the card: ``ok`` exact, ``idx`` on feasible rows (every
    row of an infeasible one is -1 in both), g within ``rtol=1e-4``."""

    @staticmethod
    def run(op, args, k, margin, dev):
        fn = trd.routing_topk if op == "topk" else trd.routing_attain
        t = as_torch(args, dev)
        before = fn.launches
        got = np_out(fn(*t, k=k, margin=margin))
        assert fn.launches == before + 1
        want = np_out(TOPK_PLAIN[op](*t, k=k, margin=margin))
        check_topk(got, want, 1e-4)
        np.testing.assert_array_equal(got[0][~want[2]], -1)

    @pytest.mark.parametrize("i,r", SWEEP)
    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_topk_kernel(self, cuda_device, i, r, k):
        self.run("topk", topk_inputs(i, r, seed=40 + i), k, 0.0,
                 cuda_device)

    @pytest.mark.parametrize("i,r", SWEEP)
    @pytest.mark.parametrize("k", [1, 3])
    def test_attain_kernel(self, cuda_device, i, r, k):
        self.run("attain", attain_inputs(i, r, seed=60 + i), k, 0.1,
                 cuda_device)

    @pytest.mark.parametrize("op", ["topk", "attain"])
    def test_window_rows(self, cuda_device, op):
        make = topk_inputs if op == "topk" else attain_inputs
        self.run(op, make(6, 128, seed=106, slo_rows=True, lam_rows=True),
                 3, 0.25, cuda_device)

    @pytest.mark.parametrize("name", EDGE_CASES)
    def test_edge_case(self, cuda_device, name):
        op, args, k, margin = edge_case(name)
        self.run(op, args, k, margin, cuda_device)


# ------------------------------------- routing row kernels' design --
# routing_score_kernel, routing_topk_kernel and routing_attain_kernel cannot
# run here; these hold the arithmetic of their shared design
# (routing_score.row_plan's lanes and slots, per-lane partials in slot
# order, width-L butterflies, the cached g, attain's band pass and the
# duplicate passes) to the plain versions.
BIG = np.float32(1e30)       # the kernels' argmin key mask
NONE = 0x7FFFFFFF            # "no column"
NEAR = np.float32(1.00001)
EPS = np.float32(1e-9)


def slot_columns(plan, i):
    """(slots, lanes) -> the column a lane's slot holds, -1 past I: the
    kernel's ``slot_col``, slot q * group + e being candidate e of the
    lane's group q (groups of four adjacent columns in rows of more than
    32 candidates, else one column a lane)."""
    out = np.full((plan.groups * plan.group, plan.lanes), -1, np.int64)
    for q in range(plan.groups):
        for e in range(plan.group):
            for s_ in range(plan.lanes):
                x = (q * plan.lanes + s_) * plan.group + e
                if x < i:
                    out[q * plan.group + e, s_] = x
    return out


def lane_better(key, col, k, c):
    """The kernels' comparator: lower key, then the lower column."""
    return (k < key) | ((k == key) & (c < col))


def butterfly_argmax_p(lanes, p, g, c):
    """Width-``lanes`` xor shuffles of ``seg_argmax_p``: the highest p,
    then the lowest g, then the lowest column; lane 0's result."""
    p, g, c = p.copy(), g.copy(), c.copy()
    off = lanes >> 1
    while off:
        partner = np.arange(lanes) ^ off
        op, og, oc = p[:, partner], g[:, partner], c[:, partner]
        take = (op > p) | ((op == p) & ((og < g) | ((og == g) & (oc < c))))
        p, g, c = (np.where(take, op, p), np.where(take, og, g),
                   np.where(take, oc, c))
        off >>= 1
    return p[:, 0], g[:, 0], c[:, 0]


def butterfly(lanes, *vals, argmin=True):
    """Width-``lanes`` xor shuffles over the lane axis (last), offsets
    lanes/2 .. 1, as ``seg_argmin`` (key, col, g) or ``seg_min`` (one
    value) leaves them on every lane; returns lane 0's result."""
    vals = [v.copy() for v in vals]
    off = lanes >> 1
    while off:
        partner = np.arange(lanes) ^ off
        other = [v[:, partner] for v in vals]
        if argmin:
            take = lane_better(vals[0], vals[1], other[0], other[1])
            vals = [np.where(take, o, v) for v, o in zip(vals, other)]
        else:
            vals = [np.minimum(vals[0], other[0])]
        off >>= 1
    return [v[:, 0] for v in vals]


def row_design(args, k, margin, mode="topk"):
    """routing_topk (``mode`` "topk"), routing_score ("score") or
    routing_attain ("attain", with attain's inputs) as the row kernels
    take it, with the plain version's g (and for attain its p): pass 1
    scores every (row, column) once into the cache and folds per-lane
    partials; pass 2 takes the primary from the cache (attain: the lowest
    (g, column) in the 1e-6 band, starting from the lowest pair that
    attains the maximum); each duplicate pass the argmin above the
    previous pick. Returns the plain versions' outputs."""
    lam, alpha, beta, gamma, mu, n, rtt, slo = as_torch(args[:8])
    table = as_torch(args[-1:])[0]
    g, rho = (x.numpy() for x in tref._table_scores(
        lam, alpha, beta, gamma, mu, n, rtt, table))
    r, i = g.shape
    slo_ = np.broadcast_to(slo.numpy(), (r, i))
    plan = trs.row_plan(i, mode)
    cols = slot_columns(plan, i)
    lanes = plan.lanes
    feas = (rho < 1.0) & (g <= slo_)
    elig = feas & (g <= slo_ - np.float32(margin))
    big = np.full((r, lanes), BIG, np.float32)
    # pass 1: per-lane feasible minimum, any, g_eff minimum (the cache is
    # g itself: each column scored once); attain: per-lane maximum p and
    # the lowest (g, column) attaining it, in the lane's column order
    gmin, geff = big.copy(), big.copy()
    anyf = np.zeros((r, lanes), bool)
    if mode == "attain":
        sigma, avail = as_torch(args[8:10])
        p = tref._attain_p(torch.as_tensor(g), torch.as_tensor(
            np.array(slo_)), sigma, avail).numpy()
        pm = np.full((r, lanes), -1.0, np.float32)
        gb, cb = big.copy(), np.full((r, lanes), NONE)
    for col in cols:
        v = col >= 0
        gc = g[:, np.where(v, col, 0)]
        f = feas[:, np.where(v, col, 0)] & v
        gmin = np.where(f, np.minimum(gmin, gc), gmin)
        anyf |= f
        ge = np.where(rho[:, np.where(v, col, 0)] < 1.0, gc,
                      np.float32(1e9))
        geff = np.where(v, np.minimum(geff, ge), geff)
        if mode == "attain":
            pc = p[:, np.where(v, col, 0)]
            take = f & ((pc > pm) | ((pc == pm) & (gc < gb)))
            pm, gb, cb = (np.where(take, pc, pm), np.where(take, gc, gb),
                          np.where(take, col, cb))
    gmin, = butterfly(lanes, gmin, argmin=False)
    geff, = butterfly(lanes, geff, argmin=False)
    anyr = anyf.any(axis=1)
    if mode == "attain":
        # pass 2: feasible columns below the pmax pair, in the band
        pmax, gstar, cstar = butterfly_argmax_p(lanes, pm, gb, cb)
        floor = (pmax - np.float32(1e-6)).astype(np.float32)[:, None]
        key = np.repeat(gstar[:, None], lanes, 1)
        best = np.repeat(cstar[:, None], lanes, 1)
        for col in cols:
            v = col >= 0
            cc = np.where(v, col, 0)
            take = (v & feas[:, cc] & anyr[:, None]
                    & lane_better(key, best, g[:, cc], col)
                    & (p[:, cc] >= floor))
            key, best = np.where(take, g[:, cc], key), \
                np.where(take, col, best)
        g0, primary, _ = butterfly(lanes, key, best, key)
        none = primary == NONE            # nothing in the band
        primary = np.where(none, 0, primary)
        g0 = np.where(none, g[:, 0], g0)
    else:
        edge = (gmin * NEAR + EPS).astype(np.float32)[:, None]
        cost_ = as_torch(args[8:9])[0].numpy()
        # pass 2: the primary from the cache
        key, best, bg = big.copy(), np.full((r, lanes), NONE), \
            np.zeros((r, lanes), np.float32)
        for col in cols:
            v = col >= 0
            cc = np.where(v, col, 0)
            near = feas[:, cc] & (g[:, cc] <= edge)
            kk = np.where(near, cost_[cc], BIG)
            take = v & lane_better(key, best, kk, col)
            key, best, bg = (np.where(take, kk, key),
                             np.where(take, col, best),
                             np.where(take, g[:, cc], bg))
        _, primary, g0 = butterfly(lanes, key, best, bg)
    if mode == "score":
        return primary.astype(np.int32), g0, anyr
    idx = [np.where(anyr, primary, -1)]
    gout = [np.where(anyr, g0, geff)]
    last_g = np.full(r, -BIG, np.float32)
    last_i = np.full(r, -1)
    left = anyr.copy()
    for _ in range(1, k):
        key, best = big.copy(), np.full((r, lanes), NONE)
        for col in cols:
            v = col >= 0
            cc = np.where(v, col, 0)
            gc = g[:, cc]
            ok = (v & elig[:, cc] & left[:, None] & (col != primary[:, None])
                  & ((gc > last_g[:, None]) | ((gc == last_g[:, None])
                                                & (col > last_i[:, None]))))
            take = ok & lane_better(key, best, gc, col)
            key, best = np.where(take, gc, key), np.where(take, col, best)
        dk, di, _ = butterfly(lanes, key, best, key)
        has = di != NONE
        idx.append(np.where(has, di, -1))
        gout.append(np.where(has, dk, np.float32(0)))
        left, last_g, last_i = has, dk, di
    return (np.stack(idx, 1).astype(np.int32),
            np.stack(gout, 1).astype(np.float32), anyr)


def design_case(name):
    """Inputs (routing_topk's order) for the design tests: the
    reference's sweeps and edges, and the layout's I edges."""
    if name.startswith("sweep"):
        i, r = map(int, name.split("_")[1:])
        return topk_inputs(i, r, seed=40 + i)
    if name.startswith("rows"):      # (R, I) rates, SLO rows, exclusions
        i, r = map(int, name.split("_")[1:])
        return topk_inputs(i, r, seed=200 + i, slo_rows=True, lam_rows=True)
    if name.startswith("shared"):    # (R,) rates, (I,) SLOs
        i, r = map(int, name.split("_")[1:])
        return topk_inputs(i, r, seed=300 + i)
    return edge_case(name)[1]


def attain_design_case(name):
    """Inputs (routing_attain's order) for the design tests: the
    reference's attain sweep draws and edges, and at every other name of
    ``DESIGN_CASES`` the topk inputs with cost replaced by sigma and
    avail drawn from a seeded generator."""
    if name.startswith("sweep"):
        i, r = map(int, name.split("_")[1:])
        return attain_inputs(i, r, seed=60 + i)
    if name.startswith("attain"):
        return edge_case(name)[1]
    args = design_case(name)
    i = args[-1].shape[0]
    rng = np.random.default_rng(500 + i)
    sigma = rng.uniform(0.05, 0.8, i).astype(np.float32)
    avail = rng.uniform(0.7, 1.0, i).astype(np.float32)
    return args[:8] + [sigma, avail, args[-1]]


DESIGN_CASES = (["sweep_2_64", "sweep_6_256", "sweep_11_128",
                 "topk_all_infeasible", "topk_k_exceeds_feasible",
                 "topk_clones"]
                + [f"rows_{i}_{r}" for i, r in ((1, 40), (31, 37),
                                                 (33, 37), (50, 37),
                                                 (130, 20), (1030, 6))]
                + [f"shared_{i}_{r}" for i, r in ((1, 40), (33, 37),
                                                  (50, 37))])


ATTAIN_DESIGN_CASES = DESIGN_CASES + [
    "attain_clones", "attain_sigma_zero", "attain_uniform",
    "attain_all_infeasible"]


class TestRowDesign:
    """The row kernels' design, not the kernels: :func:`row_design`
    re-takes routing_topk's, routing_score's and routing_attain's
    decisions in the order the kernels take them (lanes and slots from
    ``row_plan``, per-lane partials, width-L butterflies, the cached g,
    attain's band pass below the pmax pair, duplicate passes above the
    previous pick) on the plain version's g, and must give the plain
    versions' outputs field for field. The kernels themselves are held
    on the card by ``TestCudaRowLayout`` and chip_smoke.py."""

    @pytest.mark.parametrize("name", DESIGN_CASES)
    @pytest.mark.parametrize("k,margin", [(1, 0.0), (2, 0.0), (3, 0.25),
                                          (8, 0.5)])
    def test_topk_field_for_field(self, name, k, margin):
        args = design_case(name)
        got = row_design(args, k, margin)
        want = np_out(tref.routing_topk_ref(*as_torch(args), k=k,
                                            margin=margin))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name", DESIGN_CASES)
    def test_score_field_for_field(self, name):
        args = design_case(name)
        got = row_design(args, 1, 0.0, mode="score")
        want = np_out(tref.routing_score_ref(*as_torch(args)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name", ATTAIN_DESIGN_CASES)
    @pytest.mark.parametrize("k,margin", [(1, 0.0), (2, 0.0), (3, 0.25),
                                          (8, 0.5)])
    def test_attain_field_for_field(self, name, k, margin):
        args = attain_design_case(name)
        got = row_design(args, k, margin, mode="attain")
        want = np_out(tref.routing_attain_ref(*as_torch(args), k=k,
                                              margin=margin))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_every_column_in_exactly_one_slot(self):
        for i in (1, 2, 3, 5, 31, 33, 50, 130, 1023, 1024, 1025, 3000):
            cols = slot_columns(trs.row_plan(i), i)
            taken = np.sort(cols[cols >= 0])
            np.testing.assert_array_equal(taken, np.arange(i))


class TestRowPlan:
    """``routing_score.row_plan``: the layout the wrapper hands the three
    row kernels, and the scratch it keeps for rows too long for shared
    memory. The kernels check the plan against I before launch."""

    @pytest.mark.parametrize("i", [1, 2, 3, 4, 5, 16, 31, 32, 33, 64, 65,
                                   100, 129, 256, 257, 513, 1023, 1024,
                                   1025, 2944, 2945, 4096, 100_000])
    def test_lanes_slots_rows_and_shared_bytes(self, i):
        p = trs.row_plan(i)
        assert p.lanes == min(32, 1 << (i - 1).bit_length())   # pow2 >= I
        assert p.lanes >= min(i, 32)
        assert p.group == (1 if i <= 32 else 4)
        assert p.group == 1 or p.lanes == 32
        length = p.groups * p.lanes * p.group      # the row cache's floats
        assert length >= i > length - p.lanes * p.group   # no idle group
        threads = p.rows_per_block * p.lanes
        assert threads == (trs.NARROW_THREADS if p.group == 1
                           else trs.WIDE_THREADS)
        planes = trs.COLUMN_PLANES * min(length, trs.TILE) * 4
        cache = p.rows_per_block * (length * 4 + p.groups * p.lanes)
        assert p.scratch == (planes + cache > 227 * 1024)
        assert p.scratch == (i > 2944)
        assert p.smem_bytes == planes + (0 if p.scratch else cache)
        assert p.smem_bytes <= 227 * 1024

    @pytest.mark.parametrize("i", [1, 4, 32, 33, 1024, 1025, 1408, 1409,
                                   2944, 2945, 100_000])
    def test_attain_stages_sigma_avail_and_caches_p(self, i):
        """routing_attain's plan: the same lanes, groups and rows as
        routing_score's; two more staged planes (sigma, avail), in wide
        rows a list of 128 ints a row, p cached beside g, and so the cache
        in the scratch from I 1409 (2945 for the other modes)."""
        p, q = trs.row_plan(i), trs.row_plan(i, "attain")
        assert trs.row_plan(i, "topk") == p and p.cache_floats == 1
        assert trs.ATTAIN_PLANES == trs.COLUMN_PLANES + 2 == 9
        assert p[:4] == q[:4]                # lanes, group, groups, rows
        assert q.cache_floats == 2
        length = q.groups * q.lanes * q.group
        assert q.row_bytes == q.groups * q.lanes * (8 * q.group + 1)
        lists = q.rows_per_block * q.lanes * q.group * 4 if q.group == 4 \
            else 0
        staged = trs.ATTAIN_PLANES * min(length, trs.TILE) * 4 + lists
        cache = q.rows_per_block * q.row_bytes
        assert q.scratch == (staged + cache > trs.SMEM_MAX) == (i > 1408)
        assert q.smem_bytes == staged + (0 if q.scratch else cache)
        assert q.smem_bytes <= trs.SMEM_MAX

    def test_attain_fleet_shape(self):
        q = trs.row_plan(1024, "attain")
        # planes, lists, g and p caches and flags of 16 rows: one block an
        # SM (two fit only without p's cache, which was slower)
        assert q.smem_bytes == (9 * 1024 + 16 * 128 + 16 * 2048) * 4 \
            + 16 * 8 * 32
        assert q.smem_bytes + 1024 <= 228 * 1024 < 2 * (q.smem_bytes + 1024)

    def test_modes_other_than_the_kernels_raise(self):
        for mode in ("", "guard", "ATTAIN"):
            with pytest.raises(ValueError, match="mode"):
                trs.row_plan(4, mode)

    def test_main_path_fills_the_warps(self):
        """At I = 2..4 a warp decides 8 to 16 rows, not one."""
        for i, rows_per_warp in ((2, 16), (3, 8), (4, 8)):
            p = trs.row_plan(i)
            assert 32 // p.lanes == rows_per_warp
            assert p.rows_per_block == 256 // p.lanes

    def test_fleet_shape(self):
        p = trs.row_plan(1024)
        assert (p.lanes, p.group, p.groups, p.rows_per_block, p.scratch) \
            == (32, 4, 8, 16, False)
        # two blocks an SM: planes, g cache and flags of 16 rows
        assert p.smem_bytes == (7 * 1024 + 16 * 1024) * 4 + 16 * 8 * 32
        assert 2 * (p.smem_bytes + 1024) <= 228 * 1024

    def test_i_outside_the_range_raises(self):
        for i in (0, -3):
            with pytest.raises(ValueError):
                trs.row_plan(i)

    def test_scratch_is_kept_per_stream_and_grown_by_size(
            self, monkeypatch):
        monkeypatch.setattr(trs, "_SCRATCH", {})
        dev = torch.device("cpu")
        assert trs.plan_args(300, 1024, dev)[3] is None
        assert trs.plan_args(300, 2944, dev)[3] is None
        assert trs._SCRATCH == {}
        buf = trs._scratch(dev, 1, 500)
        assert buf.dtype == torch.uint8 and buf.numel() == 500
        assert trs._scratch(dev, 1, 300) is buf
        grown = trs._scratch(dev, 1, 900)
        assert grown.numel() == 900 and trs._SCRATCH[(None, 1)] is grown
        assert trs._scratch(dev, 2, 300) is not grown
        monkeypatch.setattr(trs, "stream_ptr", lambda d: 3)
        args = trs.plan_args(300, 2945, dev)
        p = trs.row_plan(2945)
        rows = -(-300 // p.rows_per_block) * p.rows_per_block
        assert args == (p.lanes, p.rows_per_block, p.smem_bytes,
                        trs._SCRATCH[(None, 3)].data_ptr())
        assert trs._SCRATCH[(None, 3)].numel() == rows * p.row_bytes
        assert p.row_bytes == p.groups * 32 * (4 * 4 + 1)
        # attain: shared memory at 1408, the scratch from 1409
        assert trs.plan_args(300, 1408, dev, "attain")[3] is None
        q = trs.row_plan(1409, "attain")
        assert trs.plan_args(300, 1409, dev, "attain") == (
            q.lanes, q.rows_per_block, q.smem_bytes,
            trs._SCRATCH[(None, 3)].data_ptr())


def calm(args, k, margin, seed, attain=False):
    """Redraw (in place) the rates of rows whose decision two float32
    evaluations of g ~1e-6 apart could flip (a g within 1e-5 of the SLO
    cut or the headroom gate, two of the k + 1 lowest feasible g within
    1e-5, or a feasible g at the near-band edge; with ``attain``, a
    feasible p within reach of the 1e-6 band edge instead): the kernel's
    exp/log/erf and the plain version's pow/lerp/erf differ in the last
    bits, and with a thousand candidates a row such near-ties occur by
    chance."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        lam, alpha, beta, gamma, mu, n, rtt, slo = as_torch(args[:8])
        table = as_torch(args[-1:])[0]
        g, rho = (x.numpy().astype(np.float64) for x in tref._table_scores(
            lam, alpha, beta, gamma, mu, n, rtt, table))
        s_ = np.broadcast_to(slo.numpy(), g.shape)
        feas = (rho < 1) & (g <= s_)
        gate = s_ - margin
        bad = ((np.abs(g - s_) <= 1e-5 * np.abs(s_))
               | (np.abs(g - gate) <= 1e-5 * np.abs(gate))).any(1)
        low = np.sort(np.where(feas, g, 1e30), 1)[:, :k + 1]
        bad |= ((np.diff(low, axis=1) <= 1e-5 * np.abs(low[:, 1:]))
                & (low[:, 1:] < 1e29)).any(1)
        cols = np.arange(g.shape[1])[None, :]
        if attain:
            sig = np.maximum(args[8].astype(np.float64), 1e-20) * np.sqrt(2)
            avail = args[9].astype(np.float64)
            z = np.clip((np.log(np.maximum(s_, 1e-20))
                         - np.log(np.maximum(g, 1e-20))) / sig, -10, 10)
            phi = 0.5 * (1 + torch.erf(torch.as_tensor(z)).numpy())
            p = np.where(feas, avail * np.where(args[8] > 0, phi, g <= s_),
                         -1.0)
            # a 1e-6 relative shift of g moves p by Phi' * 1e-6 / sig
            dp = np.where(args[8] > 0, avail * np.exp(-z * z)
                          / np.sqrt(np.pi) * 1e-6 / sig, 0.0)
            top = p.argmax(1)[:, None]
            edge = np.take_along_axis(p, top, 1) - 1e-6
            reach = dp + np.take_along_axis(dp, top, 1) + 1e-7
            bad |= (feas & (cols != top) & (np.abs(p - edge) <= reach)).any(1)
        else:
            gf = np.where(feas, g, 1e30)
            edge = gf.min(1, keepdims=True) * (1 + 1e-5) + 1e-9
            others = cols != gf.argmin(1)[:, None]
            bad |= (feas & others & (np.abs(g - edge) <= 1e-5 * edge)).any(1)
        if not bad.any():
            return args
        shape = (int(bad.sum()),) + args[0].shape[1:]
        args[0][bad] = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    raise AssertionError("no case free of near-ties")


@pytest.mark.cuda
class TestCudaRowLayout:
    """routing_score and routing_topk kernels at their layout's edges
    against the plain versions on the card: every I around a lanes or
    groups step and the scratch threshold, R = 300 (a multiple of no plan's
    rows per block), (R,) shared rates, a lam row start off a 16-byte
    boundary, and k from 1 to 8 with a margin; ``idx`` and ``ok`` exact,
    g within ``rtol=1e-4``."""

    @staticmethod
    def placed(args, dev, misalign):
        """The inputs on ``dev``; with ``misalign``, lam starting 4 bytes
        past a 16-byte boundary."""
        t = as_torch(args, dev)
        if misalign:
            buf = torch.empty(t[0].numel() + 1, device=dev)
            buf[1:].copy_(t[0].flatten())
            t[0] = buf[1:].view(t[0].shape)
            assert t[0].data_ptr() % 16 == 4
        return t

    @classmethod
    def run(cls, args, k, margin, dev, misalign=False):
        t = cls.placed(args, dev, misalign)
        before = trs.routing_score.launches, trd.routing_topk.launches
        got = np_out(trs.routing_score(*t))
        want = np_out(tref.routing_score_ref(*t))
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[0][want[2]], want[0][want[2]])
        np.testing.assert_allclose(got[1][want[2]], want[1][want[2]],
                                   rtol=1e-4)
        got = np_out(trd.routing_topk(*t, k=k, margin=margin))
        want = np_out(tref.routing_topk_ref(*t, k=k, margin=margin))
        check_topk(got, want, 1e-4, exact=True)
        assert (trs.routing_score.launches, trd.routing_topk.launches) == \
            (before[0] + 1, before[1] + 1)

    @pytest.mark.parametrize("i", [1, 2, 3, 4, 5, 16, 31, 32, 33, 1023,
                                   1024, 1025, 2945])
    def test_lanes_groups_and_scratch(self, cuda_device, i):
        args = topk_inputs(i, 300, 900 + i, slo_rows=True, lam_rows=True)
        self.run(calm(args, 2, 0.25, i), 2, 0.25, cuda_device)

    @pytest.mark.parametrize("i", [4, 33, 1024])
    def test_shared_rates(self, cuda_device, i):
        args = calm(topk_inputs(i, 300, 950 + i), 2, 0.25, i)
        self.run(args, 2, 0.25, cuda_device)

    @pytest.mark.parametrize("i", [4, 1024])
    def test_misaligned_rates(self, cuda_device, i):
        args = topk_inputs(i, 300, 970 + i, slo_rows=True, lam_rows=True)
        self.run(calm(args, 2, 0.25, i), 2, 0.25, cuda_device,
                 misalign=True)

    @pytest.mark.parametrize("k", range(1, trd.K_MAX + 1))
    @pytest.mark.parametrize("i", [5, 1024, 1025])
    def test_k_with_margin(self, cuda_device, i, k):
        args = topk_inputs(i, 300, 990 + i + k, slo_rows=True,
                           lam_rows=True)
        self.run(calm(args, k, 0.25, k), k, 0.25, cuda_device)

    @classmethod
    def run_attain(cls, args, k, margin, dev, misalign=False):
        t = cls.placed(args, dev, misalign)
        before = trd.routing_attain.launches
        got = np_out(trd.routing_attain(*t, k=k, margin=margin))
        want = np_out(tref.routing_attain_ref(*t, k=k, margin=margin))
        check_topk(got, want, 1e-4, exact=True)
        assert trd.routing_attain.launches == before + 1

    @pytest.mark.parametrize("i", [1, 2, 3, 4, 5, 16, 31, 32, 33, 1023,
                                   1024, 1025, 1408, 1409, 2945])
    def test_attain_lanes_groups_and_scratch(self, cuda_device, i):
        """routing_attain on the same body: every layout edge, and 1408 /
        1409, around the first I whose attain cache is in the scratch."""
        args = attain_inputs(i, 300, 1100 + i, slo_rows=True, lam_rows=True)
        self.run_attain(calm(args, 2, 0.25, i, attain=True), 2, 0.25,
                        cuda_device)

    @pytest.mark.parametrize("i", [4, 33, 1024])
    def test_attain_shared_rates(self, cuda_device, i):
        args = calm(attain_inputs(i, 300, 1150 + i), 2, 0.25, i, attain=True)
        self.run_attain(args, 2, 0.25, cuda_device)

    @pytest.mark.parametrize("i", [4, 1024])
    def test_attain_misaligned_rates(self, cuda_device, i):
        args = attain_inputs(i, 300, 1170 + i, slo_rows=True, lam_rows=True)
        self.run_attain(calm(args, 2, 0.25, i, attain=True), 2, 0.25,
                        cuda_device, misalign=True)

    @pytest.mark.parametrize("k", range(1, trd.K_MAX + 1))
    @pytest.mark.parametrize("i", [5, 1024, 1025])
    def test_attain_k_with_margin(self, cuda_device, i, k):
        args = attain_inputs(i, 300, 1190 + i + k, slo_rows=True,
                             lam_rows=True)
        self.run_attain(calm(args, k, 0.25, k, attain=True), k, 0.25,
                        cuda_device)


@pytest.mark.cuda
class TestCudaGuardStaging:
    """routing_guard on both sides of its staging cap (the candidates in
    shared memory up to ``GUARD_STAGE_MAX``, device memory past it),
    with top-tier rows, against the plain version: ``offloaded`` and
    ``idx`` exact, g within ``rtol=1e-4``; and the pinned tau == g_inst
    edges, held and one ulp below offloaded."""

    @pytest.mark.parametrize("lam_rows", [True, False])
    @pytest.mark.parametrize("i", [trd.GUARD_STAGE_MAX,
                                   trd.GUARD_STAGE_MAX + 1])
    def test_both_sides_of_the_staging_cap(self, cuda_device, i, lam_rows):
        args, _ = guard_stage_inputs(i, 5000 + i, lam_rows)
        t = as_torch(args, cuda_device)
        before = trd.routing_guard.launches
        got = np_out(trd.routing_guard(*t))
        assert trd.routing_guard.launches == before + 1
        check_guard(got, np_out(tref.routing_guard_ref(*t)), 1e-4)

    @pytest.mark.parametrize("i", [trd.GUARD_STAGE_MAX,
                                   trd.GUARD_STAGE_MAX + 1])
    def test_tau_edges(self, cuda_device, i):
        args, want = guard_stage_inputs(i, 5100 + i, tau_edges=True)
        t = as_torch(args, cuda_device)
        got = np_out(trd.routing_guard(*t))
        np.testing.assert_array_equal(got[2], want)
        check_guard(got, np_out(tref.routing_guard_ref(*t)), 1e-4)


# ---------------------------------------------------------- attention --
def attn_tol(dtype: str) -> dict:
    """The reference's kernel bounds (``tests/test_kernels.py``)."""
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(x: np.ndarray, dtype: str = "float32"):
    """The same values as a jax array and a torch tensor of ``dtype``
    (bfloat16 by round-to-nearest-even on both sides)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def qkv(seed, b, sq, skv, h, hkv, d, dtype="float32", q_mult=1.0,
        k_mult=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, sq, h, d)) * q_mult).astype(np.float32)
    k = (rng.normal(size=(b, skv, hkv, d)) * k_mult).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return [both(a, dtype) for a in (q, k, v)]


def decode_case(seed, b, h, hkv, d, c, dtype="float32", pos_hi=300,
                q_lo=100):
    """The reference's ``TestDecodeAttention.test_matches_ref`` draws:
    kv_pos in [-1, pos_hi), q_pos in [q_lo, pos_hi]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    kv_pos = rng.integers(-1, pos_hi, (b, c)).astype(np.int32)
    q_pos = rng.integers(q_lo, pos_hi + 1, (b,)).astype(np.int32)
    return [both(a, dtype) for a in (q, k, v)] + [
        (jnp.asarray(kv_pos), torch.from_numpy(kv_pos)),
        (jnp.asarray(q_pos), torch.from_numpy(q_pos))]


FLASH_SHAPES = [
    (1, 128, 1, 1, 64),      # the reference's sweep: minimal
    (2, 256, 4, 2, 64),      # GQA
    (2, 128, 4, 1, 32),      # MQA
    (1, 512, 2, 2, 128),     # MXU-aligned head dim
    (2, 96, 4, 4, 80),       # StableLM-3B's head_dim
    (1, 200, 2, 1, 80),      # a sequence no tile divides
]
DECODE_SHAPES = [
    (1, 1, 1, 32, 128),      # the reference's sweep
    (3, 4, 2, 64, 256),
    (2, 8, 1, 64, 512),
    (2, 4, 4, 80, 200),      # StableLM-3B's head_dim, ragged cache
]


class TestAttentionPlainAgainstJax:
    @pytest.mark.parametrize("b,s,h,hkv,d", FLASH_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal(self, b, s, h, hkv, d, dtype):
        (jq, tq), (jk, tk), (jv, tv) = qkv(s + d, b, s, s, h, hkv, d, dtype)
        want = jref.attention(jq, jk, jv, causal=True)
        got = tfa.flash_attention(tq, tk, tv, causal=True)
        assert got.dtype == tq.dtype and tuple(got.shape) == (b, s, h, d)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol(dtype))

    @pytest.mark.parametrize("window", [32, 64, 100])
    def test_sliding_window(self, window):
        (jq, tq), (jk, tk), (jv, tv) = qkv(1, 2, 256, 256, 2, 2, 32)
        want = jref.attention(jq, jk, jv, causal=True, window=window)
        got = tref.flash_attention_ref(tq, tk, tv, causal=True,
                                       window=window)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_softcap_and_scale(self):
        (jq, tq), (jk, tk), (jv, tv) = qkv(2, 1, 128, 128, 2, 2, 64,
                                           q_mult=3, k_mult=3)
        want = jref.attention(jq, jk, jv, causal=True, softcap=30.0,
                              scale=0.1)
        got = tref.flash_attention_ref(tq, tk, tv, causal=True,
                                       softcap=30.0, scale=0.1)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_non_causal(self):
        (jq, tq), (jk, tk), (jv, tv) = qkv(3, 2, 128, 128, 2, 2, 32)
        want = jref.attention(jq, jk, jv, causal=False)
        got = tref.flash_attention_ref(tq, tk, tv, causal=False)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_suffix_aligned_queries(self):
        """Sq < Skv: query i sits at position Skv - Sq + i."""
        (jq, tq), _, _ = qkv(4, 2, 40, 40, 4, 2, 16)
        _, (jk, tk), (jv, tv) = qkv(5, 2, 100, 100, 4, 2, 16)
        want = jref.attention(jq, jk, jv, causal=True, window=30)
        got = tref.flash_attention_ref(tq, tk, tv, causal=True, window=30)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_constant_v_passes_through(self):
        """Softmax rows sum to one: attention over a constant V is V."""
        (_, tq), (_, tk), _ = qkv(6, 1, 64, 64, 2, 2, 16)
        v = torch.full((1, 64, 2, 16), 3.0)
        torch.testing.assert_close(tref.flash_attention_ref(tq, tk, v), v,
                                   atol=1e-5, rtol=0)

    @pytest.mark.parametrize("b,h,hkv,d,c", DECODE_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode(self, b, h, hkv, d, c, dtype):
        args = decode_case(c + d, b, h, hkv, d, c, dtype)
        want = jref.decode_attention(*[a[0] for a in args])
        got = tda.decode_attention(*[a[1] for a in args])
        assert got.dtype == args[0][1].dtype
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol(dtype))

    def test_decode_window(self):
        args = decode_case(7, 2, 4, 2, 32, 256, pos_hi=500, q_lo=400)
        want = jref.decode_attention(*[a[0] for a in args], window=128)
        got = tref.decode_attention_ref(*[a[1] for a in args], window=128)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_decode_softcap_and_scale(self):
        args = decode_case(8, 2, 4, 2, 32, 64)
        want = jref.decode_attention(*[a[0] for a in args], softcap=30.0,
                                     scale=0.5)
        got = tref.decode_attention_ref(*[a[1] for a in args], softcap=30.0,
                                        scale=0.5)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_decode_ring_buffer(self):
        """Slots holding positions 100..163 give full attention over
        those positions with the query last."""
        (jq, tq), (jk, tk), (jv, tv) = qkv(9, 1, 1, 64, 2, 2, 16)
        kv_pos = np.arange(100, 164, dtype=np.int32)[None, :]
        q_pos = np.asarray([163], np.int32)
        want = jref.attention(jq, jk, jv, causal=True)[:, 0]
        got = tref.decode_attention_ref(tq[:, 0], tk, tv,
                                        torch.from_numpy(kv_pos),
                                        torch.from_numpy(q_pos))
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_all_invalid_row_is_the_mean_of_v(self, dtype):
        """A row with no valid slot (all kv_pos -1, or every position
        after the query) averages V uniformly, as NEG_INF = -1e30 makes
        the reference do; row 1 stays an ordinary row."""
        args = decode_case(10, 2, 4, 2, 80, 48, dtype)
        kv_pos = np.array(args[3][0])
        kv_pos[0] = -1
        q_pos = np.array(args[4][0])
        args[3] = (jnp.asarray(kv_pos), torch.from_numpy(kv_pos))
        want = jref.decode_attention(*[a[0] for a in args])
        got = tda.decode_attention(*[a[1] for a in args])
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol(dtype))
        mean_v = f32(args[2][1])[0].mean(axis=0)            # (Hkv, D)
        np.testing.assert_allclose(
            f32(got)[0], np.repeat(mean_v, 2, axis=0), **attn_tol(dtype))
        late = np.full_like(kv_pos, q_pos.max() + 1)
        args[3] = (jnp.asarray(late), torch.from_numpy(late))
        np.testing.assert_allclose(
            f32(tda.decode_attention(*[a[1] for a in args])),
            f32(jref.decode_attention(*[a[0] for a in args])),
            **attn_tol(dtype))


@pytest.mark.slow
class TestAttentionPlainAgainstPallasInterpret:
    """One small case of each kernel, as ``tests/test_kernels.py`` runs
    the Pallas kernels (interpret mode on the CPU)."""

    def test_flash_attention(self):
        (jq, tq), (jk, tk), (jv, tv) = qkv(11, 1, 128, 128, 4, 2, 32)
        want = pallas_flash_attention(jq, jk, jv, causal=True, window=48,
                                      block_q=64, block_kv=64,
                                      interpret=True)
        got = tref.flash_attention_ref(tq, tk, tv, causal=True, window=48)
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))

    def test_decode_attention(self):
        args = decode_case(12, 2, 4, 2, 32, 128)
        want = pallas_decode_attention(*[a[0] for a in args], block_kv=64,
                                       interpret=True)
        got = tref.decode_attention_ref(*[a[1] for a in args])
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))


class TestAttentionDispatch:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        (_, tq), (_, tk), (_, tv) = qkv(13, 1, 16, 16, 2, 1, 16)
        before = tfa.flash_attention.launches
        torch.testing.assert_close(tfa.flash_attention(tq, tk, tv),
                                   tref.flash_attention_ref(tq, tk, tv),
                                   rtol=0, atol=0)
        assert tfa.flash_attention.launches == before
        args = [a[1] for a in decode_case(14, 2, 2, 1, 16, 8)]
        before = tda.decode_attention.launches
        torch.testing.assert_close(tda.decode_attention(*args),
                                   tref.decode_attention_ref(*args),
                                   rtol=0, atol=0)
        assert tda.decode_attention.launches == before

    def test_facade(self):
        (_, tq), (_, tk), (_, tv) = qkv(15, 1, 8, 8, 2, 2, 8)
        torch.testing.assert_close(ops.attention(tq, tk, tv, window=4),
                                   tref.flash_attention_ref(tq, tk, tv,
                                                            window=4))
        args = [a[1] for a in decode_case(16, 1, 2, 2, 8, 8)]
        torch.testing.assert_close(ops.decode_attention(*args),
                                   tref.decode_attention_ref(*args))
        with pytest.raises(ValueError, match="cuda"):
            ops.attention(tq, tk, tv, impl="cuda")
        with pytest.raises(ValueError, match="cuda"):
            ops.decode_attention(*args, impl="cuda")
        with pytest.raises(ValueError, match="impl"):
            ops.attention(tq, tk, tv, impl="pallas")

    def test_head_checks(self):
        q = torch.zeros(1, 4, 2, 12)
        for h, hkv, d, match in ((3, 2, 16, "multiple of n_kv"),
                                 (2, 1, 12, "head_dim"),
                                 (2, 1, 264, "head_dim")):
            with pytest.raises(ValueError, match=match):
                tfa.check_heads(q, h, hkv, d)
        with pytest.raises(TypeError, match="bfloat16"):
            tfa.check_heads(q.half(), 2, 1, 16)


# ----------------------------------------- attention kernels' algorithms --
# The CUDA kernels cannot run here; these hold the arithmetic their designs
# chose to the plain version and the JAX oracle.
MODEL_BF16_TOL = dict(atol=1e-3, rtol=1e-2)   # chip_smoke's bf16 model bound


def split_partials(q, k, v, kv_pos, q_pos, splits, per, window=0,
                   softcap=0.0, scale=None):
    """Each split's float32 softmax state over its slots [s * per,
    min(C, (s + 1) * per)), as one block of the split-KV decode kernel
    leaves it: m (B, H, S) the largest logit (NEG_INF where masked), l the
    sum of exp(logit - m), acc (B, H, S, D) the exp-weighted sum of V."""
    b, h, d = q.shape
    hkv = k.shape[2]
    kf = tref._repeat_kv(k, h // hkv).float()
    vf = tref._repeat_kv(v, h // hkv).float()
    scale = d ** -0.5 if scale is None else scale
    logits = tref._softcap(torch.einsum("bhd,bchd->bhc", q.float(), kf)
                           * scale, softcap)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window > 0:
        valid &= kv_pos > (q_pos[:, None] - window)
    logits = torch.where(valid[:, None, :], logits, tref.NEG_INF)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        sl = slice(sp * per, min(k.shape[1], (sp + 1) * per))
        m = logits[:, :, sl].amax(-1)
        p = torch.exp(logits[:, :, sl] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhc,bchd->bhd", p, vf[:, sl]))
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def merge_splits(m, l, acc):
    """The kernel's merge, in split order: weights exp(m_s - max m)."""
    mx = torch.full(m.shape[:2], tref.NEG_INF)
    for sp in range(m.shape[2]):
        mx = torch.maximum(mx, m[:, :, sp])
    tot = torch.zeros(m.shape[:2])
    out = torch.zeros(acc.shape[:2] + acc.shape[3:])
    for sp in range(m.shape[2]):
        w = torch.exp(m[:, :, sp] - mx)
        tot = tot + l[:, :, sp] * w
        out = out + acc[:, :, sp] * w[..., None]
    return out / torch.clamp(tot, min=1e-30)[..., None]


# (b, h, hkv, d, c, sms): the reference's decode sweep, then C = 1, a C no
# split divides, and a cache many splits share
SPLIT_CASES = [(b, h, hkv, d, c, 132) for b, h, hkv, d, c in DECODE_SHAPES] \
    + [(2, 4, 4, 80, 1, 132), (2, 4, 2, 32, 200, 132),
       (3, 4, 2, 16, 1000, 8), (8, 32, 32, 16, 2048, 132)]


class TestSplitKVDecode:
    """The split-KV design's arithmetic, not the kernel: partials over the
    port's ``split_plan`` and their merge are written here in plain torch,
    so of the port these reach only ``split_plan``. The kernel's own merge
    is held on the card by ``TestCudaAttentionKernels`` and chip_smoke.py's
    full-cache and invalid-split cases."""

    @pytest.mark.parametrize("b,h,hkv,d,c,sms", SPLIT_CASES)
    def test_merged_splits_equal_plain_and_jax(self, b, h, hkv, d, c, sms):
        args = decode_case(c + d + sms, b, h, hkv, d, c)
        targs = [a[1] for a in args]
        splits, per = tda.split_plan(b, hkv, c, sms)
        got = merge_splits(*split_partials(*targs, splits, per))
        torch.testing.assert_close(got, tref.decode_attention_ref(*targs),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            f32(got), f32(jref.decode_attention(*[a[0] for a in args])),
            **attn_tol("float32"))

    @pytest.mark.parametrize("kw", [dict(window=128),
                                    dict(softcap=30.0, scale=0.5)],
                             ids=["window", "softcap"])
    def test_window_and_softcap(self, kw):
        args = decode_case(21, 2, 4, 2, 32, 256, pos_hi=500, q_lo=400)
        targs = [a[1] for a in args]
        splits, per = tda.split_plan(2, 2, 256, 132)
        assert splits == 4
        got = merge_splits(*split_partials(*targs, splits, per, **kw))
        torch.testing.assert_close(
            got, tref.decode_attention_ref(*targs, **kw), atol=1e-6,
            rtol=1e-6)
        np.testing.assert_allclose(
            f32(got), f32(jref.decode_attention(*[a[0] for a in args],
                                                **kw)),
            **attn_tol("float32"))

    def test_all_invalid_row_and_invalid_splits(self):
        """Row 0 has no valid slot: every split has m = NEG_INF and the
        merge weighs them by l, so the row stays uniform over all C slots.
        Row 1 is valid only in its last split: the splits before it weigh
        exactly 0."""
        args = decode_case(22, 2, 4, 2, 80, 600)
        kv_pos = np.array(args[3][0])
        kv_pos[0] = -1
        kv_pos[1, :-5] = -1
        kv_pos[1, -5:] = 7
        q_pos = np.array([300, 10], np.int32)
        args[3] = (jnp.asarray(kv_pos), torch.from_numpy(kv_pos))
        args[4] = (jnp.asarray(q_pos), torch.from_numpy(q_pos))
        targs = [a[1] for a in args]
        splits, per = tda.split_plan(2, 2, 600, 132)
        m, l, acc = split_partials(*targs, splits, per)
        assert splits == 10 and bool((m[0] == tref.NEG_INF).all())
        assert bool((m[1, :, :-1] == tref.NEG_INF).all())
        got = merge_splits(m, l, acc)
        torch.testing.assert_close(got, tref.decode_attention_ref(*targs),
                                   atol=1e-6, rtol=1e-6)
        mean_v = targs[2][0].float().mean(0).repeat_interleave(2, 0)
        torch.testing.assert_close(got[0], mean_v, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            f32(got), f32(jref.decode_attention(*[a[0] for a in args])),
            **attn_tol("float32"))

    def test_ring_buffer(self):
        """Slots holding positions 100..355 out of order (a wrapped ring)
        split four ways give full attention over those positions."""
        (jq, tq), (jk, tk), (jv, tv) = qkv(23, 1, 1, 256, 2, 2, 16)
        order = np.roll(np.arange(256), 70)
        kv_pos = (100 + order).astype(np.int32)[None, :]
        q_pos = np.asarray([355], np.int32)
        splits, per = tda.split_plan(1, 2, 256, 132)
        assert splits == 4
        got = merge_splits(*split_partials(
            tq[:, 0], tk[:, order], tv[:, order], torch.from_numpy(kv_pos),
            torch.from_numpy(q_pos), splits, per))
        want = jref.attention(jq, jk, jv, causal=True)[:, 0]
        np.testing.assert_allclose(f32(got), f32(want), **attn_tol("float32"))


class TestSplitPlan:
    @pytest.mark.parametrize("b,hkv,c,sms", [
        (8, 32, 2048, 132), (8, 32, 512, 132), (4, 32, 2048, 132),
        (1, 1, 1, 132), (2, 4, 200, 132), (1, 8, 100000, 132),
        (64, 32, 2048, 132), (3, 5, 777, 16), (1, 1, 64, 132)])
    def test_every_slot_in_exactly_one_split(self, b, hkv, c, sms):
        splits, per = tda.split_plan(b, hkv, c, sms)
        bounds = [(s * per, min(c, (s + 1) * per)) for s in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == c
        assert all(lo < hi for lo, hi in bounds)                 # none empty
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
        assert per % tda.SPLIT_TILE == 0                   # whole tiles ...
        if b * hkv >= tda.WAVES * sms:
            assert splits == 1                   # ... and no split needed
        else:        # two waves of blocks, or splits of a single tile each
            assert b * hkv * splits >= tda.WAVES * sms \
                or per == tda.SPLIT_TILE

    def test_served_shape_fills_two_waves(self):
        splits, per = tda.split_plan(8, 32, 2048, 132)
        assert 8 * 32 * splits >= 264
        assert (splits, per) == (2, 1024)

    def test_workspace_is_kept_per_stream_and_grown_by_size(self,
                                                            monkeypatch):
        monkeypatch.setattr(tda, "_WORK", {})
        dev = torch.device("cpu")
        part, tickets = tda._workspace(dev, 1, 500, 16)
        assert part.numel() == 500 and part.dtype == torch.float32
        assert tickets.numel() == 1024 and not bool(tickets.any())
        again = tda._workspace(dev, 1, 300, 16)
        assert again[0] is part and again[1] is tickets
        grown = tda._workspace(dev, 1, 900, 2000)
        assert grown[0].numel() == 900 and grown[1].numel() == 2000
        assert not bool(grown[1].any())
        other = tda._workspace(dev, 2, 300, 16)
        assert other[0] is not grown[0] and other[1] is not grown[1]


def flash_bf16_p_split(q, k, v, tile=64, parts=2):
    """The bf16 flash kernel's arithmetic, causal and square: float32
    logits in log2 units, an online softmax over tiles of 64 keys, and P
    split into bf16 hi (p truncated) + lo (p - hi, rounded) for P V; the
    row sums add the float32 weights. ``parts=1`` is the design it
    replaced: P rounded once to bf16, the row sums adding the rounded
    weights. Returns float32, before the output's rounding."""
    b, s, h, d = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    sl2 = d ** -0.5 * 1.4426950408889634
    m = torch.full((b, h, s, 1), tref.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    pos = torch.arange(s)[:, None]
    for j0 in range(0, s, tile):
        key = torch.arange(j0, min(j0 + tile, s))[None, :]
        x = (qf @ kf[:, :, j0:j0 + tile].transpose(-1, -2)) * sl2
        x = torch.where(key <= pos, x, torch.tensor(tref.NEG_INF))
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - mx)
        corr = torch.exp2(m - mx)
        if parts == 1:
            pb = p.to(torch.bfloat16).float()
            l = l * corr + pb.sum(-1, keepdim=True)
            o = o * corr + pb @ vf[:, :, j0:j0 + tile]
        else:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            lo = (p - hi).to(torch.bfloat16).float()
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + (hi @ vf[:, :, j0:j0 + tile]
                            + lo @ vf[:, :, j0:j0 + tile])
        m = mx
    return (o / l).transpose(1, 2)


class TestFlashBf16Precision:
    """P is the wgmma A operand in bf16. One bf16 part (2^-9 per weight)
    would put the kernel 4e-3 from the float32 plain version at the served
    shape and outside MODEL_BF16_TOL; hi + lo parts (2^-17) stay inside.
    These check the design's arithmetic in a plain emulation written here,
    not the kernel: its P split is held on the card by
    ``TestCudaAttentionKernels`` and chip_smoke.py, every bf16 case at
    MODEL_BF16_TOL."""

    def test_p_in_two_bf16_parts_stays_inside_the_model_bound(self):
        (_, tq), (_, tk), (_, tv) = qkv(24, 2, 512, 512, 4, 4, 80,
                                        "bfloat16")
        got = flash_bf16_p_split(tq, tk, tv)
        exact = tref.flash_attention_ref(tq.float(), tk.float(), tv.float())
        assert (got - exact).abs().max().item() < 1e-4
        torch.testing.assert_close(
            got.to(torch.bfloat16).float(),
            tref.flash_attention_ref(tq, tk, tv).float(), **MODEL_BF16_TOL)

    def test_one_bf16_part_misses_the_model_bound_at_the_served_shape(self):
        """B 8, S 512, 32 heads of 80: one part is ~4e-3 from the float32
        plain version before the output's rounding and lands outside
        MODEL_BF16_TOL; two parts are ~6e-6 away and inside."""
        (_, tq), (_, tk), (_, tv) = qkv(27, 8, 512, 512, 32, 32, 80,
                                        "bfloat16")
        exact = tref.flash_attention_ref(tq.float(), tk.float(), tv.float())
        want = tref.flash_attention_ref(tq, tk, tv).float()
        one = flash_bf16_p_split(tq, tk, tv, parts=1)
        two = flash_bf16_p_split(tq, tk, tv)
        assert (one - exact).abs().max().item() > 1e-3
        assert not torch.allclose(one.to(torch.bfloat16).float(), want,
                                  **MODEL_BF16_TOL)
        assert (two - exact).abs().max().item() < 2e-5
        torch.testing.assert_close(two.to(torch.bfloat16).float(), want,
                                   **MODEL_BF16_TOL)

    def test_hi_is_p_truncated_and_lo_carries_the_rest(self):
        p = torch.rand(4096) * 1.5
        hi = (p.view(torch.int32) & -65536).view(torch.float32)
        assert torch.equal(hi, hi.to(torch.bfloat16).float())
        assert bool(((p - hi) >= 0).all())
        err = (hi + (p - hi).to(torch.bfloat16).float() - p).abs() / p
        assert err.max().item() <= 2.0 ** -16


@pytest.mark.cuda
class TestCudaAttentionKernels:
    """The CUDA attention kernels against their plain versions on the
    card, in the working dtype, at the reference's bounds."""

    @pytest.mark.parametrize("b,s,h,hkv,d", FLASH_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("window", [0, 100])
    def test_flash_attention_kernel(self, cuda_device, b, s, h, hkv, d,
                                    dtype, window):
        t = [a[1].to(cuda_device) for a in qkv(s + d, b, s, s, h, hkv, d,
                                                dtype)]
        before = tfa.flash_attention.launches
        got = tfa.flash_attention(*t, causal=True, window=window)
        assert tfa.flash_attention.launches == before + 1
        want = tref.flash_attention_ref(*t, causal=True, window=window)
        np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()),
                                   **attn_tol(dtype))

    def test_flash_softcap_non_causal_and_suffix(self, cuda_device):
        (_, tq), (_, tk), (_, tv) = qkv(17, 2, 40, 100, 4, 2, 16, q_mult=3,
                                        k_mult=3)
        t = [x.to(cuda_device) for x in (tq, tk, tv)]
        for kw in (dict(causal=True, softcap=30.0, scale=0.1),
                   dict(causal=False), dict(causal=True, window=30)):
            np.testing.assert_allclose(
                f32(tfa.flash_attention(*t, **kw).cpu()),
                f32(tref.flash_attention_ref(*t, **kw).cpu()),
                **attn_tol("float32"))

    @pytest.mark.parametrize("b,h,hkv,d,c", DECODE_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_attention_kernel(self, cuda_device, b, h, hkv, d, c,
                                     dtype):
        t = [a[1].to(cuda_device) for a in decode_case(c + d, b, h, hkv, d,
                                                        c, dtype)]
        t[3][0] = -1                      # an all-invalid row
        before = tda.decode_attention.launches
        got = tda.decode_attention(*t, window=0)
        assert tda.decode_attention.launches == before + 1
        want = tref.decode_attention_ref(*t)
        np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()),
                                   **attn_tol(dtype))
        for kw in (dict(window=64), dict(softcap=30.0, scale=0.5)):
            np.testing.assert_allclose(
                f32(tda.decode_attention(*t, **kw).cpu()),
                f32(tref.decode_attention_ref(*t, **kw).cpu()),
                **attn_tol(dtype))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_split_kv_decode_kernel(self, cuda_device, dtype):
        """Many splits of one cache, whole splits with no valid slot and
        an all-invalid row, merged inside the one launch."""
        t = [a[1].to(cuda_device) for a in decode_case(25, 2, 8, 2, 80,
                                                        1000, dtype)]
        t[3][1, :-5] = -1
        t[3][0] = -1
        sms = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        assert tda.split_plan(2, 2, 1000, sms)[0] > 1
        np.testing.assert_allclose(
            f32(tda.decode_attention(*t).cpu()),
            f32(tref.decode_attention_ref(*t).cpu()), **attn_tol(dtype))

    @pytest.mark.parametrize("d", [8, 24, 80, 128, 256])
    def test_flash_bf16_head_dims_and_short_keys(self, cuda_device, d):
        t = [a[1].to(cuda_device) for a in qkv(26 + d, 2, 100, 100, 8, 2,
                                                d, "bfloat16")]
        np.testing.assert_allclose(
            f32(tfa.flash_attention(*t).cpu()),
            f32(tref.flash_attention_ref(*t).cpu()), **attn_tol("bfloat16"))
        short = [t[0], t[1][:, :40], t[2][:, :40]]          # Sq > Skv
        np.testing.assert_allclose(
            f32(tfa.flash_attention(*short).cpu()),
            f32(tref.flash_attention_ref(*short).cpu()),
            **attn_tol("bfloat16"))

    def test_kernels_reject_what_they_do_not_take(self, cuda_device):
        (_, tq), (_, tk), (_, tv) = qkv(18, 1, 8, 8, 2, 2, 16)
        t = [x.to(cuda_device) for x in (tq, tk, tv)]
        with pytest.raises(TypeError):
            tfa.flash_attention(t[0].double(), t[1].double(), t[2].double())
        with pytest.raises(ValueError, match="contiguous"):
            tfa.flash_attention(t[0].transpose(1, 2).contiguous()
                                .transpose(1, 2), t[1], t[2])


# ------------------------------------------------------------------- SSD
SSD_TOL = dict(atol=2e-5, rtol=2e-5)
# y in bfloat16: the two sides agree in float32 to ~1e-6 and may then
# round to neighbouring bf16 values, at most 2^-7 of the value apart
SSD_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
SSD_PALLAS_TOL = dict(atol=5e-4, rtol=5e-4)   # the reference's own bound
# (b, l, h, p, g, n): the shapes of the reference's TestSSDScan sweep
SSD_SHAPES = [(1, 64, 1, 16, 1, 8), (2, 128, 4, 32, 2, 16),
              (2, 128, 4, 32, 4, 16), (1, 256, 2, 64, 1, 32)]


def ssd_case(seed, b, l, h, p, g, n, dtype="float32", h0=False,
             dt_scale=1.0, bc_scale=0.3, skip=True):
    """The reference ``TestSSDScan`` draws, made with numpy: x ~ N(0, 1),
    dt = softplus(N(0, 1)) * dt_scale, a = -exp(N(0, 1) / 2), b and c ~
    N(0, 1) * bc_scale, d_skip ~ N(0, 1) (zero unless ``skip``), h0 ~
    N(0, 1) when asked. Returns (jax args, torch args, numpy dt * a);
    x, b and c in ``dtype``, the rest float32; the last arg is h0 or
    None."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (np.logaddexp(rng.normal(size=(b, l, h)), 0.0) * dt_scale) \
        .astype(np.float32)
    a = -np.exp(rng.normal(size=h) * 0.5).astype(np.float32)
    bb = (rng.normal(size=(b, l, g, n)) * bc_scale).astype(np.float32)
    cc = (rng.normal(size=(b, l, g, n)) * bc_scale).astype(np.float32)
    d_skip = rng.normal(size=h).astype(np.float32) if skip \
        else np.zeros(h, np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32) if h0 else None
    pairs = [both(x, dtype), both(dt), both(a), both(bb, dtype),
             both(cc, dtype), both(d_skip)]
    jargs = [j for j, _ in pairs]
    targs = [t for _, t in pairs]
    jargs.append(None if init is None else jnp.asarray(init))
    targs.append(None if init is None else torch.from_numpy(init))
    return jargs, targs, dt * a[None, None, :]


def jax_ssd(args):
    return jref.ssd_scan(*args[:6], initial_state=args[6],
                         return_final_state=True)


def torch_ssd(args, fn=None):
    fn = fn or tref.ssd_scan_ref
    return fn(*args[:6], initial_state=args[6], return_final_state=True)


def check_ssd(got, want, tol=SSD_TOL, y_tol=None):
    (gy, gh), (wy, wh) = got, want
    assert gy.dtype == got[0].dtype and gh.dtype == torch.float32
    np.testing.assert_allclose(f32(gy), f32(wy), **(y_tol or tol))
    np.testing.assert_allclose(f32(gh), f32(wh), **tol)


class TestSSDPlainAgainstJax:
    @pytest.mark.parametrize("b,l,h,p,g,n", SSD_SHAPES)
    def test_reference_shapes(self, b, l, h, p, g, n):
        jargs, targs, _ = ssd_case(l + p + g, b, l, h, p, g, n)
        got = torch_ssd(targs)
        assert tuple(got[0].shape) == (b, l, h, p)
        assert tuple(got[1].shape) == (b, h, p, n)
        check_ssd(got, jax_ssd(jargs))

    def test_initial_state_continuation(self):
        """The first half, then the second half from the first's final
        state, equals the whole sequence (the prefill -> decode
        contract), here and in the reference."""
        jargs, targs, _ = ssd_case(1, 1, 128, 2, 16, 1, 8, skip=False)
        half = 64

        def part(args, sl, init):
            return [args[0][:, sl], args[1][:, sl], args[2],
                    args[3][:, sl], args[4][:, sl], args[5], init]
        y1, h1 = torch_ssd(part(targs, slice(0, half), None))
        y2, h2 = torch_ssd(part(targs, slice(half, None), h1))
        full = torch_ssd(targs)
        check_ssd((torch.cat([y1, y2], 1), h2), full)
        check_ssd(full, jax_ssd(jargs))

    @pytest.mark.parametrize("l", [1, 100, 200])
    def test_lengths_no_chunk_divides(self, l):
        jargs, targs, _ = ssd_case(30 + l, 2, l, 4, 16, 2, 8, h0=True)
        check_ssd(torch_ssd(targs), jax_ssd(jargs))

    def test_long_memory(self):
        """dt scaled down so that every chunk of 64 keeps at least a
        tenth of the state it starts from, over 10 chunks, with no skip
        term: a fault in the carry shows in every later chunk."""
        jargs, targs, dta = ssd_case(40, 1, 640, 2, 32, 1, 16, h0=True,
                                     dt_scale=0.005, bc_scale=1.0,
                                     skip=False)
        chunk_decay = np.exp(dta.reshape(1, 10, 64, 2).sum(axis=2))
        assert chunk_decay.min() >= 0.1
        check_ssd(torch_ssd(targs), jax_ssd(jargs))

    def test_bf16_inputs(self):
        jargs, targs, _ = ssd_case(50, 2, 100, 4, 32, 2, 16, "bfloat16",
                                   h0=True)
        got = torch_ssd(targs)
        assert got[0].dtype == torch.bfloat16
        check_ssd(got, jax_ssd(jargs), y_tol=SSD_BF16_TOL)


@pytest.mark.slow
class TestSSDPlainAgainstPallasInterpret:
    def test_ssd_scan(self):
        """One small case, as ``tests/test_kernels.py`` runs the Pallas
        kernel (interpret mode on the CPU), at its bound."""
        jargs, targs, _ = ssd_case(60, 1, 128, 2, 16, 1, 8, h0=True)
        want = pallas_ssd_scan(*jargs[:6], initial_state=jargs[6],
                               return_final_state=True, chunk=64,
                               interpret=True)
        check_ssd(torch_ssd(targs), want, tol=SSD_PALLAS_TOL)


class TestSSDDispatch:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        _, targs, _ = ssd_case(61, 1, 16, 2, 8, 1, 4, h0=True)
        before = tss.ssd_scan.launches
        got = torch_ssd(targs, tss.ssd_scan)
        assert tss.ssd_scan.launches == before
        for g, w in zip(got, torch_ssd(targs)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        y = tss.ssd_scan(*targs[:6])
        assert isinstance(y, torch.Tensor) and y.shape == targs[0].shape

    def test_facade(self):
        _, targs, _ = ssd_case(62, 1, 8, 2, 8, 1, 4)
        y, h = ops.ssd_scan(*targs[:6], return_final_state=True)
        want = torch_ssd(targs)
        torch.testing.assert_close(y, want[0], rtol=0, atol=0)
        torch.testing.assert_close(h, want[1], rtol=0, atol=0)
        with pytest.raises(ValueError, match="cuda"):
            ops.ssd_scan(*targs[:6], impl="cuda")
        with pytest.raises(ValueError, match="impl"):
            ops.ssd_scan(*targs[:6], impl="pallas")

    def test_heads_must_split_into_groups(self):
        _, targs, _ = ssd_case(63, 1, 8, 3, 8, 2, 4)
        with pytest.raises(ValueError, match="G 2"):
            tref.ssd_scan_ref(*targs[:6])


def split_bf16(v: torch.Tensor, parts: int = 2) -> torch.Tensor:
    """v as the bf16 kernel feeds a float32 operand to the tensor cores:
    hi (v truncated to bf16) + lo (v - hi rounded to bf16), or with
    ``parts=1`` v rounded once to bf16; returned as float32."""
    if parts == 1:
        return v.to(torch.bfloat16).float()
    hi = (v.view(torch.int32) & -65536).view(torch.float32)
    return hi + (v - hi).to(torch.bfloat16).float()


def ssd_bf16_chunked(x, dt, a, b, c, d_skip, h0=None, one_part=(),
                     chunk=64):
    """The bf16 SSD kernel's arithmetic, written plainly: per chunk of 64
    steps seg = cumsum(dt a), S = C B^T of the bf16 inputs summed in
    float32, M = S exp(seg_i - seg_j) dt_j for i >= j, y = exp(seg_i)
    C H_prev^T + M x + d_skip x, then H = exp(seg_last) H + (x w)^T B with
    w = exp(seg_last - seg) dt. M, H_prev and x w enter their products as
    hi + lo bf16 parts, or as one bf16 part for each of them named in
    ``one_part`` ("m", "h", "xw"). Returns y in float32, before the
    output's rounding, and the final state."""
    bsz, length, heads, hp = x.shape
    groups, n = b.shape[2], b.shape[3]
    rep = heads // groups
    xf = x.float().transpose(1, 2)                         # (B, H, L, P)
    bf = b.float().repeat_interleave(rep, 2).transpose(1, 2)
    cf = c.float().repeat_interleave(rep, 2).transpose(1, 2)
    dtt = dt.transpose(1, 2)                               # (B, H, L)
    h = torch.zeros(bsz, heads, hp, n) if h0 is None else h0.clone()

    def part(v, name):
        return split_bf16(v, 1 if name in one_part else 2)
    ys = []
    for c0 in range(0, length, chunk):
        xs, bs, cs, dts = (t[:, :, c0:c0 + chunk] for t in (xf, bf, cf, dtt))
        low = torch.ones(xs.shape[2], xs.shape[2], dtype=torch.bool).tril()
        seg = torch.cumsum(dts * a[None, :, None], -1)
        diff = torch.where(low, seg[..., :, None] - seg[..., None, :], 0.0)
        m = torch.where(low, (cs @ bs.transpose(-1, -2)) * torch.exp(diff)
                        * dts[..., None, :], 0.0)
        y = (cs @ part(h, "h").transpose(-1, -2)) * torch.exp(seg)[..., None]
        ys.append(y + part(m, "m") @ xs
                  + xs * d_skip[None, :, None, None])
        w = torch.exp(seg[..., -1:] - seg) * dts
        h = torch.exp(seg[..., -1])[..., None, None] * h \
            + part(xs * w[..., None], "xw").transpose(-1, -2) @ bs
    return torch.cat(ys, 2).transpose(1, 2), h


_PRECISION_CASES: dict = {}


def ssd_precision_case(kind: str):
    """(bf16 args, plain y and final state, float32 plain y) for the
    model's a (-linspace(1, 16, H): B 1, L 512, 8 heads of 64, N 128) or
    the long-memory case (dt x 0.005, b and c x 1.0, an initial state, no
    skip: B 1, L 640, 4 heads of 64, N 128)."""
    if kind not in _PRECISION_CASES:
        if kind == "model":
            _, t, _ = ssd_case(0, 1, 512, 8, 64, 1, 128, "bfloat16")
            t[2] = -torch.linspace(1.0, 16.0, 8)
        else:
            _, t, dta = ssd_case(0, 1, 640, 4, 64, 1, 128, "bfloat16",
                                 h0=True, dt_scale=0.005, bc_scale=1.0,
                                 skip=False)
            assert np.exp(dta.reshape(1, 10, 64, 4).sum(2)).min() >= 0.1
        want = torch_ssd(t)
        exact = tref.ssd_scan_ref(t[0].float(), t[1], t[2], t[3].float(),
                                  t[4].float(), t[5], initial_state=t[6])
        _PRECISION_CASES[kind] = (t, want, exact)
    return _PRECISION_CASES[kind]


class TestSSDBf16Precision:
    """The bf16 SSD body feeds three float32 operands to bf16 tensor-core
    products: M, H_prev and x w dt. Each goes as hi + lo bf16 parts (each
    weight errs by ~2^-17); one part (2^-9) misses MODEL_BF16_TOL on these
    draws, whichever of the three is left whole. These check the design's
    arithmetic in a plain emulation written here, not the kernel: the
    kernel is held on the card by ``TestCudaSSDKernel`` and chip_smoke.py,
    every bf16 case at MODEL_BF16_TOL."""

    @pytest.mark.parametrize("kind", ["model", "long_memory"])
    def test_hi_lo_parts_stay_inside_the_model_bound(self, kind):
        t, (want_y, want_h), exact = ssd_precision_case(kind)
        y, h = ssd_bf16_chunked(*t[:6], h0=t[6])
        # the float32 sums alone: ~2e-4 where max |y| is ~20
        assert (y - exact).abs().max().item() < 5e-4
        torch.testing.assert_close(y.to(torch.bfloat16).float(),
                                   want_y.float(), **MODEL_BF16_TOL)
        torch.testing.assert_close(h, want_h, **MODEL_BF16_TOL)

    @pytest.mark.parametrize("one_part", [("m", "h", "xw"), ("m",), ("h",),
                                          ("xw",)])
    @pytest.mark.parametrize("kind", ["model", "long_memory"])
    def test_one_bf16_part_misses_the_model_bound(self, kind, one_part):
        t, (want_y, _), _ = ssd_precision_case(kind)
        y, _ = ssd_bf16_chunked(*t[:6], h0=t[6], one_part=one_part)
        assert not torch.allclose(y.to(torch.bfloat16).float(),
                                  want_y.float(), **MODEL_BF16_TOL)


@pytest.mark.cuda
class TestCudaSSDKernel:
    """The CUDA SSD kernel against its plain version on the card, y and
    the final state, at the reference's kernel bound in float32 and one
    bf16 step in bfloat16."""

    CASES = [dict(b=b, l=l, h=h, p=p, g=g, n=n)
             for b, l, h, p, g, n in SSD_SHAPES] + [
        dict(b=2, l=1, h=4, p=16, g=2, n=8, h0=True),
        dict(b=2, l=100, h=4, p=16, g=2, n=8, h0=True),
        dict(b=1, l=200, h=2, p=64, g=1, n=128, h0=True),
        dict(b=1, l=640, h=2, p=32, g=1, n=16, h0=True, dt_scale=0.005,
             bc_scale=1.0, skip=False),
        # the bf16 body's edges (chip_smoke.SSD_CASES): P 64 and below
        # with initial states; N no multiple of 16 (12 and P 20 stage by
        # threads); L 1, 65, 127; B 5 x 32 heads
        dict(b=1, l=130, h=4, p=64, g=2, n=128, h0=True),
        dict(b=1, l=130, h=3, p=40, g=1, n=64, h0=True),
        dict(b=1, l=130, h=2, p=24, g=1, n=32, h0=True),
        dict(b=2, l=100, h=4, p=32, g=2, n=8),
        dict(b=1, l=100, h=2, p=64, g=1, n=24, h0=True),
        dict(b=2, l=100, h=4, p=64, g=1, n=72, h0=True),
        dict(b=1, l=100, h=2, p=20, g=1, n=12, h0=True),
        dict(b=2, l=1, h=4, p=64, g=2, n=128, h0=True),
        dict(b=2, l=65, h=4, p=64, g=4, n=64, h0=True),
        dict(b=1, l=127, h=4, p=40, g=2, n=24, h0=True),
        dict(b=5, l=130, h=32, p=64, g=2, n=72, h0=True),
        dict(b=5, l=65, h=32, p=40, g=4, n=24),
        dict(b=5, l=1, h=32, p=64, g=1, n=8, h0=True),
        dict(b=5, l=70, h=32, p=50, g=1, n=12, h0=True),
        dict(b=5, l=70, h=32, p=20, g=2, n=16),
        # Falcon-H1's head, wider than the tiles: P 128 as two heads of
        # 64, N 256 in two launches (and each alone)
        dict(b=2, l=130, h=4, p=128, g=2, n=256, h0=True),
        dict(b=1, l=65, h=2, p=128, g=1, n=128),
        dict(b=1, l=100, h=2, p=64, g=1, n=256, h0=True),
    ]

    @pytest.mark.parametrize("case", range(len(CASES)))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ssd_scan_kernel(self, cuda_device, case, dtype):
        _, targs, _ = ssd_case(70 + case, dtype=dtype, **self.CASES[case])
        t = [None if a is None else a.to(cuda_device) for a in targs]
        before = tss.ssd_scan.launches
        got = torch_ssd(t, tss.ssd_scan)
        # one launch a slice of N the tiles hold
        slices = -(-self.CASES[case]["n"] // tss.MAX_STATE)
        assert tss.ssd_scan.launches == before + slices
        want = torch_ssd(t)
        check_ssd([v.cpu() for v in got], [v.cpu() for v in want],
                  tol=SSD_PALLAS_TOL if dtype == "float32"
                  else dict(atol=1e-3, rtol=1e-2))

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        _, targs, _ = ssd_case(80, 1, 8, 2, 8, 1, 4)
        t = [None if a is None else a.to(cuda_device) for a in targs]
        with pytest.raises(TypeError):
            tss.ssd_scan(t[0].half(), *t[1:3], t[3].half(), t[4].half(),
                         t[5])
        with pytest.raises(ValueError, match="contiguous"):
            tss.ssd_scan(t[0].transpose(1, 2).contiguous().transpose(1, 2),
                         *t[1:6])
        _, big, _ = ssd_case(81, 1, 8, 2, 72, 1, 4)
        with pytest.raises(ValueError, match="P 72"):
            tss.ssd_scan(*[a.to(cuda_device) for a in big[:6]])
