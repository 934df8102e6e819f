"""The port's training stack (``repro_torch.training``) against the JAX
package's (``repro.training``), on the CPU.

* ``lr_schedule`` and ``global_norm`` against the reference's;
  ``apply_updates`` fed the same gradients for 5 steps, float32 and
  bf16 state: params, m and v within ``OPT_REL`` relative.
* ``SyntheticText`` batches equal to the reference's bit for bit.
* Checkpoints: round trip, gc, shape mismatch, and the cross-format test
  in both directions (a directory written by one package restored by the
  other) over nested dict / list trees with float32, bf16 and int32
  leaves.
* The ``train_step`` twin of ``test_arch_smoke.py::test_train_step`` on
  all ten reduced configs under ``kernels="ref"`` and ``"fused"``: the
  reference's weights from ``PRNGKey(0)`` (RG-LRU gates and MoE routers
  redrawn, as the model files do, so no gate is constant and no router
  is near-tied) carried across with ``convert.model_params_from_numpy``
  and its AdamW state with ``convert.opt_state_from_numpy``; B 2, S 32
  (Whisper 32 frames, T 16), tokens and labels drawn with numpy. The
  reference runs its default impl (``"ref"``): its ``"fused"`` SSD
  gradient is NaN on reduced Mamba2-370m (``tests/test_torch_fused.py``).
  Metrics (loss, nll, moe_aux, grad_norm, lr) within ``METRIC_REL``
  relative; gradients leaf by leaf within ``GRAD_REL`` x the leaf's
  largest |gradient| (measured: at most 3.7e-5 of it, reduced Mamba2
  under ``"fused"``; the others below 8.3e-6). The optimizer is held
  apart from the gradients: the port's ``apply_updates`` is fed the
  reference's gradients and must give the reference's params and state
  within ``OPT_REL``. Adam moves a parameter by about lr whatever its
  gradient's size, so a near-zero gradient whose float32 sign differs
  between the frameworks would flip the step; comparing updated params
  after each framework's own gradients would hold rounding, not the
  port.
* Regressions of the repairs training needs: a backward through the
  RG-LRU block with a carried state and through reduced RecurrentGemma-2B
  matches ``jax.grad`` (the doubling scan runs out of place under
  autograd and equals the in-place form bit for bit), ``train_step``
  refuses ``kernels="cuda"``, and the whole step runs under one
  ``float32_gemms`` scope.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import model as jm
from repro.models import rglru as jrg
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticText as JSyntheticText
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import rglru as trg
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from repro_torch.training.data import DataConfig, SyntheticText
from test_torch_models import random_gates
from test_torch_moe import redraw_routers
from test_torch_rglru import block_pair

METRIC_REL = 1e-5
GRAD_REL = 1e-4
OPT_REL = 1e-6
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
B, S, T = 2, 32, 16


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def t_of(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_rel_to_max(got, want, rel, what=""):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, what
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def assert_trees_close(got, want_numpy, cfg, rel, what, before=None):
    """``got`` (a port tree) against a reference tree with numpy leaves,
    carried across to the port's layout, leaf by leaf: each element
    within ``rel`` of the larger of its reference value and, given
    ``before``, its value before the step (an update that cancels a
    parameter to near zero keeps the rounding of the terms it
    subtracted)."""
    want = model_params_from_numpy(want_numpy, cfg, device="cpu",
                                   dtype=torch.float32)
    olds = topt.leaves(before) if before is not None else \
        [torch.zeros(())] * len(topt.leaves(want))
    for i, (a, b, old) in enumerate(zip(topt.leaves(got), topt.leaves(want),
                                        olds)):
        a, b, old = np_of(a), np_of(b), np_of(old)
        bound = rel * np.maximum(np.abs(b), np.abs(old))
        bad = np.abs(a - b) > bound
        assert not bad.any(), (f"{what} leaf {i}: {int(bad.sum())} of "
                               f"{bad.size} past {rel}, worst "
                               f"{float(np.abs(a - b)[bad].max())}")


# -------------------------------------------------------------- optimizer
class TestOptimizer:
    @pytest.mark.parametrize("warmup,total", [(100, 1000), (10, 200),
                                              (0, 50)])
    def test_lr_schedule_is_the_reference(self, warmup, total):
        jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=warmup,
                              total_steps=total)
        tc = topt.AdamWConfig(lr=1e-3, warmup_steps=warmup,
                              total_steps=total)
        steps = np.arange(0, total + 20, 3, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(jc, s))(
            jnp.asarray(steps)))
        got = np.array([float(topt.lr_schedule(tc, torch.tensor(int(s))))
                        for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=OPT_REL, atol=0)

    def tree(self, seed=0, scale=1.0):
        """A params-like tree: matrices, vectors, a 3-d leaf, lists."""
        rng = np.random.default_rng(seed)
        draw = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
        return {"w": draw(16, 8), "b": draw(8),
                "layers": [{"k": draw(4, 4, 2), "s": draw(3)},
                           {"k": draw(4, 4, 2), "s": draw(3)}]}

    @staticmethod
    def to_port(tree):
        return topt.tree_map(t_of, tree)

    def test_global_norm_is_the_reference(self):
        tree = self.tree(1, 3.0)
        want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
        got = float(topt.global_norm(self.to_port(tree)))
        assert got == pytest.approx(want, rel=OPT_REL)

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
    def test_five_steps_match_the_reference(self, state_dtype):
        """The same gradients for 5 steps (one large enough to clip, one
        of zeros in a leaf): params, m and v within OPT_REL."""
        jc = jopt.AdamWConfig(lr=0.05, warmup_steps=2, total_steps=8,
                              state_dtype=state_dtype)
        tc = topt.AdamWConfig(lr=0.05, warmup_steps=2, total_steps=8,
                              state_dtype=state_dtype)
        jp = jax.tree.map(jnp.asarray, self.tree(2))
        tp = self.to_port(self.tree(2))
        js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
        assert ts["m"]["w"].dtype == getattr(torch, state_dtype)
        for step in range(5):
            g = self.tree(10 + step, scale=(0.1, 5.0, 0.3, 1.0, 0.02)[step])
            g["b"][:] = 0.0 if step == 3 else g["b"]
            jp, js, jstats = jopt.apply_updates(
                jp, jax.tree.map(jnp.asarray, g), js, jc)
            tp, ts, tstats = topt.apply_updates(tp, self.to_port(g), ts, tc)
            for name, got, want in (("params", tp, jp), ("m", ts["m"],
                                                         js["m"]),
                                    ("v", ts["v"], js["v"])):
                topt.tree_map(lambda a, b: np.testing.assert_allclose(
                    np_of(a), np.asarray(b, np.float32), rtol=OPT_REL,
                    atol=0, err_msg=f"step {step} {name}"), got, want)
            assert int(ts["step"]) == int(js["step"]) == step + 1
            for key in ("grad_norm", "lr"):
                assert float(tstats[key]) == pytest.approx(
                    float(jstats[key]), rel=OPT_REL)

    def test_inputs_are_not_modified(self):
        cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0)
        tp = self.to_port(self.tree(3))
        before = [p.clone() for p in topt.leaves(tp)]
        st = topt.init_opt_state(tp, cfg)
        new, st2, _ = topt.apply_updates(tp, self.to_port(self.tree(4)), st,
                                         cfg)
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     topt.leaves(tp)))
        assert int(st["step"]) == 0 and int(st2["step"]) == 1
        assert not torch.equal(new["w"], tp["w"])


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_text_is_the_reference_bit_for_bit(seed):
    jds = JSyntheticText(JDataConfig(vocab_size=1000, seq_len=48,
                                     batch_size=3, seed=seed))
    tds = SyntheticText(DataConfig(vocab_size=1000, seq_len=48,
                                   batch_size=3, seed=seed))
    for _ in range(3):
        want, got = jds.batch(), tds.batch()
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------- checkpoint
def port_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.linspace(-2, 3, 4).to(torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)},
            "lst": [torch.zeros(2), torch.ones(3),
                    {"d": torch.full((2, 2), 0.1).to(torch.bfloat16)}]}


def jax_tree():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) + 0.5,
            "nested": {"b": jnp.linspace(-1, 2, 4).astype(jnp.bfloat16),
                       "c": jnp.asarray(-3, jnp.int32)},
            "lst": [jnp.full((2,), 4.0), jnp.arange(3.0),
                    {"d": jnp.full((2, 2), 0.3).astype(jnp.bfloat16)}]}


def same_bits(port_leaf: torch.Tensor, jax_leaf) -> bool:
    arr = np.asarray(jax_leaf)
    if port_leaf.dtype == torch.bfloat16:
        return arr.dtype == ml_dtypes.bfloat16 and np.array_equal(
            port_leaf.view(torch.int16).numpy(), arr.view(np.int16))
    return str(port_leaf.dtype).removeprefix("torch.") == arr.dtype.name \
        and np.array_equal(port_leaf.numpy(), arr)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = port_tree()
        path = tckpt.save(tree, str(tmp_path), step=5)
        assert os.path.basename(path) == "step_00000005"
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 5
        assert manifest["dtypes"]["nested__b"] == "bfloat16"
        assert manifest["dtypes"]["lst__idx2__d"] == "bfloat16"
        assert manifest["dtypes"]["nested__c"] == "int32"
        got = tckpt.restore(tree, str(tmp_path))
        assert isinstance(got["lst"], list)
        for a, b in zip(topt.leaves(tree), topt.leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_latest_and_gc(self, tmp_path):
        tree = {"x": torch.ones(2)}
        for s in (1, 2, 3, 4):
            tckpt.save({"x": torch.full((2,), float(s))}, str(tmp_path),
                       step=s, keep=2)
        assert tckpt.latest_step(str(tmp_path)) == 4
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
        assert steps == [3, 4]
        assert float(tckpt.restore(tree, str(tmp_path))["x"][0]) == 4.0
        assert float(tckpt.restore(tree, str(tmp_path), step=3)["x"][0]) \
            == 3.0
        assert tckpt.latest_step(str(tmp_path / "none")) is None
        with pytest.raises(FileNotFoundError):
            tckpt.restore(tree, str(tmp_path / "empty"))

    def test_shape_mismatch_raises(self, tmp_path):
        tckpt.save({"x": torch.ones(2)}, str(tmp_path), step=0)
        with pytest.raises(ValueError, match="shape mismatch for x"):
            tckpt.restore({"x": torch.ones(3)}, str(tmp_path))

    def test_port_writes_the_reference_reads(self, tmp_path):
        tree = port_tree()
        tckpt.save(tree, str(tmp_path), step=7)
        like = jax.tree.map(lambda t: jnp.zeros(t.shape), jax_tree())
        got = jckpt.restore(like, str(tmp_path))
        assert all(topt.leaves(topt.tree_map(same_bits, tree, got)))

    def test_reference_writes_the_port_reads(self, tmp_path):
        tree = jax_tree()
        jckpt.save(tree, str(tmp_path), step=9)
        got = tckpt.restore(port_tree(), str(tmp_path))
        assert tckpt.latest_step(str(tmp_path)) == 9
        assert all(topt.leaves(topt.tree_map(same_bits, got, tree)))


# ------------------------------------------------------- train-step twin
def batch_for(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    seq = T if cfg.is_encoder_decoder else S
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, seq))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)) \
            .astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)) \
            .astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def reference_step():
    """arch -> the reference's step on its reduced config, computed once:
    cfgs, numpy weights and batch, its loss / extras / grads, its AdamW
    state before and after one ``apply_updates`` of those grads."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
            tree = random_gates(jax.tree.map(np.asarray, jm.init_params(
                jax.random.PRNGKey(0), jc)))
            if jc.n_experts:
                tree = redraw_routers(tree)
            jp = jax.tree.map(jnp.asarray, tree)
            batch = batch_for(jc)
            (loss, extras), grads = jax.value_and_grad(
                jtrain.loss_fn, has_aux=True)(
                jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
            ocfg = jopt.AdamWConfig(lr=1e-3, state_dtype=jc.opt_state_dtype)
            st = jopt.init_opt_state(jp, ocfg)
            new_p, new_st, stats = jopt.apply_updates(jp, grads, st, ocfg)
            to_np = lambda t: jax.tree.map(np.asarray, t)
            cache[arch] = dict(
                jc=jc, tc=tc, tree=tree, batch=batch, grads=to_np(grads),
                st=to_np(st), new_p=to_np(new_p), new_st=to_np(new_st),
                metrics={"loss": float(loss), "nll": float(extras["nll"]),
                         "moe_aux": float(extras["moe_aux"]),
                         "grad_norm": float(stats["grad_norm"]),
                         "lr": float(stats["lr"])})
        return cache[arch]
    return get


@pytest.mark.parametrize("kernels", ["ref", "fused"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference(arch, kernels, reference_step):
    ref_ = reference_step(arch)
    tc = ref_["tc"]
    params = model_params_from_numpy(ref_["tree"], tc, device="cpu")
    state = ttrain.TrainState(
        params, opt_state_from_numpy(ref_["st"], tc, device="cpu"),
        topt.AdamWConfig(lr=1e-3, state_dtype=tc.opt_state_dtype))
    new_state, metrics = ttrain.train_step(state, tc, ref_["batch"],
                                           kernels=kernels)
    for key, want in ref_["metrics"].items():
        assert float(metrics[key]) == pytest.approx(want, rel=METRIC_REL,
                                                    abs=0), key
    moved = [not torch.equal(a, b) for a, b in
             zip(topt.leaves(params), topt.leaves(new_state.params))]
    assert any(moved), f"{arch}: no param update"
    assert int(new_state.opt_state["step"]) == 1

    # gradients, leaf by leaf
    _, _, grads = ttrain.value_and_grad(params, tc, ref_["batch"], kernels)
    want = model_params_from_numpy(ref_["grads"], tc, device="cpu")
    for i, (a, b) in enumerate(zip(topt.leaves(grads), topt.leaves(want))):
        assert_rel_to_max(a, b, GRAD_REL, f"{arch} grad leaf {i}")

    # the optimizer, fed the reference's gradients. The two global norms
    # of those gradients differ by the reference's float32 summation
    # error (the port's is within 1e-6 of a float64 sum; the reference's
    # up to 5.6e-7 off it on reduced DBRX): m scales with the clip
    # factor and v with its square, so their bounds add that gap once
    # and twice
    new_p, new_st, stats = topt.apply_updates(
        params, want, opt_state_from_numpy(ref_["st"], tc, device="cpu"),
        state.opt_cfg, ttrain.decay_mask(tc, params))
    exact = np.sqrt(sum(float(np.square(np.asarray(g, np.float64)).sum())
                        for g in jax.tree.leaves(ref_["grads"])))
    assert float(stats["grad_norm"]) == pytest.approx(exact, rel=OPT_REL)
    gap = abs(float(stats["grad_norm"]) / ref_["metrics"]["grad_norm"] - 1)
    assert_trees_close(new_p, ref_["new_p"], tc, OPT_REL, "params", params)
    assert_trees_close(new_st["m"], ref_["new_st"]["m"], tc, OPT_REL + gap,
                       "m")
    assert_trees_close(new_st["v"], ref_["new_st"]["v"], tc,
                       OPT_REL + 2 * gap, "v")


def test_cuda_kernels_are_refused_before_any_work():
    tc = reduced(get_config("stablelm_3b"))
    state = ttrain.make_train_state(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        ttrain.train_step(state, tc, batch_for(tc), kernels="cuda")
    with pytest.raises(ValueError, match="kernels='fused' or 'ref'"):
        ttrain.make_functional_step(tc, state.opt_cfg, kernels="cuda")


def test_make_train_state_and_functional_step():
    tc = reduced(get_config("mamba2_370m"))
    state = ttrain.make_train_state(tc, seed=1, lr=1e-3, total_steps=50,
                                    device="cpu")
    assert state.opt_cfg.total_steps == 50
    assert state.opt_state["m"]["embed"].dtype == torch.float32
    step = ttrain.make_functional_step(tc, state.opt_cfg, kernels="fused")
    params, opt_state, metrics = step(state.params, state.opt_state,
                                      batch_for(tc, seed=2))
    assert set(metrics) == {"loss", "nll", "moe_aux", "grad_norm", "lr"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    _, _, again = step(params, opt_state, batch_for(tc, seed=2))
    assert float(again["loss"]) < float(metrics["loss"])


def test_step_runs_in_one_float32_gemm_scope(monkeypatch):
    """The backward and the update see the step's GEMM settings: every
    ``torch.matmul`` of the step, forward, recompute and backward, runs
    with float32 matmul precision "highest", whatever the caller set."""
    tc = reduced(get_config("stablelm_3b"))
    state = ttrain.make_train_state(tc, seed=0, device="cpu")
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            seen.append(("fwd", torch.get_float32_matmul_precision()))
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("bwd", torch.get_float32_matmul_precision()))
            return g

    real_norm = tl.apply_norm
    monkeypatch.setattr(tl, "apply_norm",
                        lambda kind, p, x, *eps: real_norm(
                            kind, p, Probe.apply(x), *eps))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        ttrain.train_step(state, tc, batch_for(tc), kernels="fused")
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert after == "medium"
    assert {kind for kind, _ in seen} == {"fwd", "bwd"}
    assert all(p == "highest" for _, p in seen), seen


# ------------------------------------------------- the RG-LRU's backward
def test_linear_scan_out_of_place_is_bit_identical():
    rng = np.random.default_rng(20)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 8))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 8)).astype(np.float32))
    want = trg.linear_scan(a.clone(), b.clone())
    ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = trg.linear_scan(ag, bg)
    assert torch.equal(got, want) and got.grad_fn is not None
    ga, gb = torch.autograd.grad(got.square().sum(), (ag, bg))
    # autograd through the sequential recurrence
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    h, hs = torch.zeros(2, 8), []
    for t in range(37):
        h = a2[:, t] * h + b2[:, t]
        hs.append(h)
    wa, wb = torch.autograd.grad(torch.stack(hs, 1).square().sum(), (a2, b2))
    np.testing.assert_allclose(np_of(ga), np_of(wa), **LAYER_TOL)
    np.testing.assert_allclose(np_of(gb), np_of(wb), **LAYER_TOL)


def test_rglru_block_backward_with_a_state_matches_the_reference():
    jc, tc, jp, tp = block_pair(seed=3)
    rng = np.random.default_rng(21)
    w = trg.width(tc)
    u = rng.standard_normal((2, 24, tc.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, tc.conv_width - 1, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)

    def jloss(params, u, h0):
        out, st = jrg.forward(params, jc, u, state={
            "conv": jnp.asarray(conv), "h": h0}, return_state=True)
        return jnp.sum(jnp.square(out)) + jnp.sum(jnp.square(st["h"]))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(u),
                                             jnp.asarray(h0))
    tparams = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tu, th0 = t_of(u).requires_grad_(True), t_of(h0).requires_grad_(True)
    out, st = trg.forward(tparams, tc, tu, state={"conv": t_of(conv),
                                                  "h": th0},
                          return_state=True, kernels="fused")
    loss = out.square().sum() + st["h"].square().sum()
    names = sorted(tparams)
    grads = torch.autograd.grad(loss, [tparams[k] for k in names] + [tu, th0])
    for name, g in zip(names, grads):
        assert_rel_to_max(g, jg[0][name], GRAD_REL, name)
    assert_rel_to_max(grads[-2], jg[1], GRAD_REL, "u")
    assert_rel_to_max(grads[-1], jg[2], GRAD_REL, "h0")
    assert th0.grad is None and torch.equal(th0, t_of(h0))
