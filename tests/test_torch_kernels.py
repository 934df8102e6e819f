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

Tests marked ``cuda`` run the hand-written kernels against the plain
versions and skip without a card (``python3 chip_smoke.py`` runs the
same checks there at full width).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.routing_decide import routing_attain as pallas_attain
from repro.kernels.routing_decide import routing_guard as pallas_guard
from repro.kernels.routing_decide import routing_topk as pallas_topk
from repro.kernels.routing_score import build_erlang_table as j_table
from repro.kernels.routing_score import routing_score as pallas_score
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import routing_decide as trd
from repro_torch.kernels import routing_score as trs

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


class TestGuardEdges:
    """The reference's pinned guard edges (tests/test_kernels.py)."""

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
