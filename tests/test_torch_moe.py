"""The port's mixture-of-experts layer and MoE decoders against the JAX
package's, on the CPU.

``repro_torch.models.layers.moe`` is held to ``repro.models.layers.moe``
and the reduced ``dbrx_132b`` and ``arctic_480b`` (2 layers, d_model 256,
4 experts of d_ff 512, top-2; Arctic with its dense residual MLP) to the
reference model on the same inputs: numpy draws from stated seeds, and
weights drawn by the reference's ``init_params`` from
``jax.random.PRNGKey(0)`` carried across by
``convert.model_params_from_numpy``. The routers are redrawn first
(``ROUTER_STD`` per weight), and every case asserts from the port's
routing record (``layers.MOE_RECORD``) that no token's k-th and
(k+1)-th router probabilities are near-tied: their gap is above
``REL_GAP_MIN`` of the k-th. The two frameworks' float32 router logits
differ by ~1e-6, and so their probabilities by ~1e-6 of themselves: a
gap of ``REL_GAP_MIN`` leaves each choice far from a flip.

The reference's routing is read through the reference's own code: its
``lax.top_k`` result and the dispatch record it hands its combine
(slot, token, gate, keep in expert-sorted order), recorded by wrapping
``jax.lax.top_k`` and ``jax.vmap`` for the call. Every (token, choice)'s
expert, kept flag and buffer slot must be equal, and in the overflow
case the dropped count (> 0) too.

Tolerances: the layer's output ``atol = rtol = 1e-5`` and its aux loss
``1e-6`` in float32; in bf16 one bf16 step (``2^-7`` of the largest
output); logits ``atol = rtol = 1e-4``, caches ``2e-5`` (the model
files' bounds).

XLA's CPU runtime has no batched bf16 x bf16 -> float32 dot
("Unsupported element type for DotThunk"), so the bf16 case runs the
reference's expert einsums on operands upcast to float32
(``f32_einsum``): bf16 products are exact in float32, so that is the
same product with float32 accumulation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import layers as jl
from repro.models import model as jm
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.serving import ServingEngine
from test_torch_models import check_layer_caches, np_of, t_of

MOE = ["dbrx_132b", "arctic_480b"]
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = 1e-6
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ROUTER_STD = 0.25          # the redrawn routers' weights ~ N(0, 0.25^2)
REL_GAP_MIN = 1e-4   # (p_k - p_k+1) / p_k above this for every token


def moe_pair(arch: str):
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


def redraw_routers(tree: dict, seed: int = 11) -> dict:
    """``tree`` (a reference pytree with numpy leaves) with every MoE
    router redrawn ~ N(0, ROUTER_STD^2), float32."""
    rng = np.random.default_rng(seed)
    for layer in tree["blocks"].values():
        r = layer["moe"]["router"]
        layer["moe"]["router"] = (rng.normal(size=r.shape) * ROUTER_STD) \
            .astype(np.float32)
    return tree


def moe_params(arch: str):
    """(reference cfg, jax params, port cfg, port params) of the reduced
    ``arch``, routers redrawn."""
    jc, tc = moe_pair(arch)
    tree = redraw_routers(jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jc)))
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            model_params_from_numpy(tree, tc, device="cpu"))


@pytest.fixture
def record(monkeypatch):
    """The port's routing records of every ``moe`` call in the test."""
    records: list = []
    monkeypatch.setattr(tl, "MOE_RECORD", records)
    return records


def assert_no_near_tie(records) -> None:
    assert records, "no MoE layer ran"
    gap = min(float(((r["top"][:, -2] - r["top"][:, -1])
                     / r["top"][:, -2]).min()) for r in records)
    assert gap > REL_GAP_MIN, f"a router near-tie: relative gap {gap}"


def f32_einsum(einsum):
    """``jnp.einsum`` that runs a bf16 product with a float32 result on
    operands upcast to float32 (the same product: see the module
    docstring)."""
    def call(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32 and any(
                o.dtype == jnp.bfloat16 for o in ops):
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(eq, *ops, preferred_element_type=preferred_element_type,
                      **kw)
    return call


def reference_moe(monkeypatch, params: dict, x, **kw):
    """The reference layer's (y, aux) and its routing per (token, choice):
    experts (T, k), kept flags and slots, read from its ``lax.top_k`` and
    the record its dispatch hands its combine."""
    seen = {}
    top_k, vmap = jax.lax.top_k, jax.vmap

    def rec_top_k(probs, k):
        seen["top"] = top_k(probs, k)
        return seen["top"]

    def rec_vmap(fn, *a, **k):
        mapped = vmap(fn, *a, **k)
        if fn.__name__ != "combine_one":
            return mapped

        def call(out_e, info):
            seen["info"] = info
            return mapped(out_e, info)
        return call
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jax, "vmap", rec_vmap)
        m.setattr(jnp, "einsum", f32_einsum(jnp.einsum))
        y, aux = jl.moe(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                        **kw)
    gate_idx = np.asarray(seen["top"][1])[0]                  # (T, k)
    slot, tok, _, keep = (np.asarray(a)[0] for a in seen["info"])
    e = params["router"].shape[1]
    cap = int(max(1, round(gate_idx.shape[0] * kw["top_k"] / e
                           * kw.get("capacity_factor", 1.25))))
    slots = np.full(gate_idx.shape, -1)
    kept = np.zeros(gate_idx.shape, bool)
    for s_, t_, k_ in zip(slot, tok, keep):
        j = int(np.nonzero(gate_idx[t_] == s_ // cap)[0][0])
        slots[t_, j], kept[t_, j] = s_, k_
    return np.asarray(y), float(aux), gate_idx, kept, slots


def layer_params(tp: dict) -> dict:
    return tp["layers"][0]["moe"]


def check_layer(monkeypatch, record, tp, tc, x):
    """The port's layer against the reference's on ``x``: output, aux,
    and every (token, choice)'s expert, kept flag and slot. Returns the
    reference's kept flags."""
    kw = dict(top_k=tc.top_k, kind=tc.mlp_kind)
    params = {k: np_of(v) for k, v in layer_params(tp).items()}
    jy, jaux, j_idx, j_keep, j_slot = reference_moe(monkeypatch, params, x,
                                                    **kw)
    ty, taux = tl.moe(layer_params(tp), t_of(x), **kw)
    assert_no_near_tie(record)
    got = record[-1]
    np.testing.assert_array_equal(np_of(got["gate_idx"]), j_idx)
    np.testing.assert_array_equal(np_of(got["keep"]), j_keep)
    np.testing.assert_array_equal(np_of(got["slot"]), j_slot)
    np.testing.assert_allclose(np_of(ty), jy, **MOE_TOL)
    assert abs(float(taux) - jaux) <= AUX_TOL
    return j_keep


@pytest.mark.parametrize("arch", MOE)
class TestMoELayer:
    def test_matches_the_reference(self, arch, monkeypatch, record):
        _, _, tc, tp = moe_params(arch)
        x = np.random.default_rng(60).normal(
            size=(2, 24, tc.d_model)).astype(np.float32)
        check_layer(monkeypatch, record, tp, tc, x)

    def test_overflow_drops_what_the_reference_drops(self, arch,
                                                     monkeypatch, record):
        """Every token leans to expert 0 (its router column has a large
        component along a direction all tokens share): 48 tokens x 2
        choices over 4 experts give cap 30, and expert 0 overflows."""
        _, _, tc, tp = moe_params(arch)
        rng = np.random.default_rng(61)
        u = rng.normal(size=tc.d_model)
        u /= np.linalg.norm(u)
        router = layer_params(tp)["router"]
        router[:, 0] += torch.from_numpy(4.0 * u).float()
        x = (rng.normal(size=(3, 16, tc.d_model)) + 2.0 * u) \
            .astype(np.float32)
        keep = check_layer(monkeypatch, record, tp, tc, x)
        assert record[-1]["cap"] == 30
        dropped = int((~keep).sum())
        assert dropped > 0
        assert int((~np_of(record[-1]["keep"])).sum()) == dropped

    def test_decode_capacity_of_two_tokens(self, arch, monkeypatch, record):
        """Two tokens (a decode step of two slots), top-2 of 4 experts:
        cap = round(1.25) = 1."""
        _, _, tc, tp = moe_params(arch)
        x = np.random.default_rng(62).normal(
            size=(2, 1, tc.d_model)).astype(np.float32)
        check_layer(monkeypatch, record, tp, tc, x)
        assert record[-1]["cap"] == 1

    def test_bf16_within_one_bf16_step(self, arch, monkeypatch, record):
        """Experts in bf16, the router float32, as a bf16 model holds
        them: the output within one bf16 step of the largest output."""
        _, _, tc, tp = moe_params(arch)
        params = {k: v if k == "router" else v.to(torch.bfloat16)
                  for k, v in layer_params(tp).items()}
        x = np.random.default_rng(63).normal(
            size=(2, 24, tc.d_model)).astype(np.float32)
        xb = t_of(x).to(torch.bfloat16)
        jy = reference_moe(
            monkeypatch, {k: v if k == "router" else
                          jnp.asarray(np_of(v), jnp.bfloat16)
                          for k, v in params.items()},
            jnp.asarray(np_of(xb), jnp.bfloat16), top_k=tc.top_k,
            kind=tc.mlp_kind)[0]
        ty, _ = tl.moe(params, xb, top_k=tc.top_k, kind=tc.mlp_kind)
        assert ty.dtype == torch.bfloat16
        assert_no_near_tie(record)
        jy = jy.astype(np.float32)
        step = 2.0 ** -7 * float(np.abs(jy).max())
        np.testing.assert_allclose(np_of(ty), jy, atol=step, rtol=0)


@pytest.mark.parametrize("kind", ["geglu", "relu2", "gelu"])
def test_other_mlp_kinds_match_the_reference(kind, monkeypatch, record):
    """The expert FFN's other kinds (no served MoE config uses them): the
    gated geglu with the float32 gate, and the non-gated relu2 and gelu
    without ``wg``."""
    _, _, tc, tp = moe_params("dbrx_132b")
    params = dict(layer_params(tp))
    if kind != "geglu":
        del params["wg"]
    tc = dataclasses.replace(tc, mlp_kind=kind)
    x = np.random.default_rng(66).normal(
        size=(2, 24, tc.d_model)).astype(np.float32)
    check_layer(monkeypatch, record, {"layers": [{"moe": params}]}, tc, x)


@pytest.mark.parametrize("tokens,top_k,experts,cap", [
    (4096, 4, 16, 1280),     # DBRX prefill, 8 x 512
    (8, 4, 16, 2),           # DBRX decode, 8 slots: round(2.5) is 2
    (4096, 2, 128, 80),      # Arctic prefill
    (8, 2, 128, 1),          # Arctic decode: round(0.156) is 0, then 1
    (2, 2, 4, 1),            # the reduced configs at two tokens
    (48, 2, 4, 30),
])
def test_capacity_is_the_reference_expression(tokens, top_k, experts, cap):
    assert tl.moe_capacity(tokens, top_k, experts, 1.25) == cap == \
        int(max(1, round(tokens * top_k / experts * 1.25)))


@pytest.mark.parametrize("arch", MOE)
class TestMoEModels:
    def test_forward_matches_the_reference(self, arch, record):
        jc, jp, tc, tp = moe_params(arch)
        tokens = np.random.default_rng(64).integers(
            0, tc.vocab_size, (2, 40)).astype(np.int32)
        jlog, jaux = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
        tlog, taux = tm.forward(tp, tc, {"tokens": t_of(tokens)},
                                kernels="ref")
        assert_no_near_tie(record)
        assert len(record) == tc.n_layers
        np.testing.assert_allclose(np_of(tlog), np.asarray(jlog),
                                   **LOGIT_TOL)
        assert float(jaux) > 0 and abs(float(taux) - float(jaux)) <= AUX_TOL

    def test_prefill_and_decode_match_the_reference(self, arch, record):
        """A prefill of 2 x 40 tokens and 16 decode steps (two tokens a
        step, cap 1: the decode steps drop whenever both slots pick one
        expert); logits and caches every step."""
        jc, jp, tc, tp = moe_params(arch)
        b, s = 2, 40
        rng = np.random.default_rng(65)
        tokens = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
        jlog, jcache = jm.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
        tlog, tcache = tm.prefill(tp, tc, {"tokens": t_of(tokens)},
                                  kernels="ref")
        np.testing.assert_allclose(np_of(tlog), np.asarray(jlog),
                                   **LOGIT_TOL)
        check_layer_caches(tcache, jcache, jc)
        pos = np.full((b,), s, np.int32)
        for _ in range(16):
            tok = rng.integers(0, tc.vocab_size, (b,)).astype(np.int32)
            jlog, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                          jnp.asarray(pos))
            tlog, tcache = tm.decode_step(tp, tc, t_of(tok), tcache,
                                          t_of(pos), kernels="ref")
            np.testing.assert_allclose(np_of(tlog), np.asarray(jlog),
                                       **LOGIT_TOL)
            check_layer_caches(tcache, jcache, jc)
            pos = pos + 1
        assert_no_near_tie(record)
        assert all(r["cap"] == 1 for r in record[tc.n_layers:])
        assert any(not bool(r["keep"].all()) for r in record[tc.n_layers:])

    @pytest.mark.parametrize("b,s,steps,slots,max_len", [
        (3, 16, 6, 3, 16),      # b == slots: adopts the 16-deep ring
        (2, 24, 6, 4, 40),      # b < slots: merged; idle slots compete
    ], ids=["b_eq_slots", "b_lt_slots"])
    def test_engine_greedy_tokens_match(self, arch, b, s, steps, slots,
                                        max_len, record):
        jc, jp, tc, tp = moe_params(arch)
        p = np.random.default_rng(b * 100 + s).integers(
            0, tc.vocab_size, (b, s)).astype(np.int32)
        want = JaxEngine(jc, jp, slots=slots, max_len=max_len) \
            .generate(jnp.asarray(p), steps=steps)
        got = ServingEngine(tc, tp, slots=slots, max_len=max_len,
                            device="cpu", kernels="ref") \
            .generate(p, steps=steps)
        assert_no_near_tie(record)
        np.testing.assert_array_equal(got.tokens, want.tokens)

    def test_layers_carry_the_reference_blocks(self, arch):
        jc, tc = moe_pair(arch)
        p = tm.init_params(tc, device="meta")
        for layer in p["layers"]:
            assert "mlp" not in layer
            assert set(layer["moe"]) == {"router", "wi", "wg", "wo"}
            assert ("dense_mlp" in layer) == tc.dense_residual


def test_router_arrives_in_float32_in_a_bf16_model():
    """The reference draws the router in float32 whatever the model's
    dtype; the converter keeps it so, beside bf16 experts."""
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in moe_pair("arctic_480b"))
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jc))
    assert tree["blocks"]["layer0"]["moe"]["router"].dtype == np.float32
    tp = model_params_from_numpy(tree, tc, device="cpu")
    for layer in tp["layers"]:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["wi"].dtype == torch.bfloat16
        assert layer["dense_mlp"]["wi"].dtype == torch.bfloat16
    own = tm.init_params(tc, device="meta")["layers"][0]["moe"]
    assert own["router"].dtype == torch.float32
    assert own["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np_of(tp["layers"][1]["moe"]["router"]),
        tree["blocks"]["layer0"]["moe"]["router"][1])


@pytest.mark.parametrize("arch", MOE)
def test_moe_active_lt_total(arch):
    cfg = get_config(arch)
    assert tm.active_param_count(cfg) < tm.param_count(cfg)


@pytest.mark.parametrize("arch,total,active", [
    ("dbrx_132b", 131_597_021_184, 36_470_206_464),
    ("arctic_480b", 476_850_275_328, 15_584_314_368),
    ("whisper_small", 277_940_736, 277_940_736),
])
def test_param_counts_match_the_reference(arch, total, active):
    """On the full configs, from the meta-device init (no allocation);
    the reference's counts come from its ``eval_shape``."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert tm.param_count(cfg) == jm.param_count(jcfg) == total
    assert tm.active_param_count(cfg) == jm.active_param_count(jcfg) \
        == active


def test_chip_check_compares_expert_sets():
    """``chip_smoke.moe_routes``, the card's check of the two kernel
    routes' routing: a swap of order inside a token's top k is no flip;
    a changed set is, and its plain-route k-th minus (k+1)-th gap is
    reported only at the token's first flip (its state differs after)."""
    import chip_smoke as cs

    def rec(idx, top):
        idx = torch.tensor(idx)
        return {"gate_idx": idx, "keep": torch.ones_like(idx, dtype=bool),
                "top": torch.tensor(top)}
    want = [rec([[0, 1], [2, 3]], [[.5, .3, .1], [.4, .35, .2]]),
            rec([[0, 1], [2, 3]], [[.5, .3, .29], [.4, .35, .2]])]
    got = [rec([[1, 0], [2, 1]], [[.5, .3, .1], [.4, .35, .2]]),
           rec([[0, 2], [3, 1]], [[.5, .3, .29], [.4, .35, .2]])]
    routes = cs.moe_routes(got, want)
    assert routes["assign_equal"] == [False, False]
    assert routes["flipped_tokens"] == [1, 2]
    assert routes["first_flip_gap"][0] == pytest.approx(0.15, abs=1e-6)
    assert routes["first_flip_gap"][1] == pytest.approx(0.01, abs=1e-6)
    assert routes["flipped"].tolist() == [True, True]
    same = cs.moe_routes(got[:1], [rec([[1, 0], [3, 2]],
                                       [[.5, .3, .1], [.4, .35, .2]])])
    assert same["assign_equal"] == [False]
    assert same["flipped_tokens"] == [1]
    swap = cs.moe_routes([rec([[1, 0]], [[.5, .3, .1]])],
                         [rec([[0, 1]], [[.5, .3, .1]])])
    assert swap["assign_equal"] == [True]
    assert swap["first_flip_gap"] == [None]
