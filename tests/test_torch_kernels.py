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
reference's own ``5e-4``.

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
    ]

    @pytest.mark.parametrize("case", range(len(CASES)))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ssd_scan_kernel(self, cuda_device, case, dtype):
        _, targs, _ = ssd_case(70 + case, dtype=dtype, **self.CASES[case])
        t = [None if a is None else a.to(cuda_device) for a in targs]
        before = tss.ssd_scan.launches
        got = torch_ssd(t, tss.ssd_scan)
        assert tss.ssd_scan.launches == before + 1
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
