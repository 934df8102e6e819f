"""The port's model stack against the JAX package's, on the CPU.

Layers, the decoder-only transformer and the model API of
``repro_torch.models`` are held to ``repro.models`` on the same inputs:
numpy draws from stated seeds, and weights drawn by the reference's
``init_params`` from ``jax.random.PRNGKey(0)`` (as
``tests/test_serving.py`` makes them) carried across by
``repro_torch.convert.model_params_from_numpy``. Both sides run float32
at ``reduced(...)`` widths (2 layers, d_model 256, 4 heads), the
reference through its pure-jnp attention oracle, the port through the
plain versions of its attention kernels (``kernels="ref"``).

The expert-free decoders of slice 6 (``DECODERS``: reduced
``recurrentgemma_2b`` with the pattern (rglru, rglru, local), the four
dense configs and ``gemma2_27b@sw``) are held the same way at a prompt of
80 tokens against a 64-token window, so every local layer's ring wraps in
prefill and in decode; RecurrentGemma's gates are drawn at random in the
reference's weights before they are carried across (its zero init makes
r and i a constant 0.5). Their configs equal the reference's field for
field with equal ``param_count``.

The Mamba-2 cases hold ``repro_torch.models.ssm`` and the reduced
``mamba2_370m`` (2 layers, d_model 256, 16 SSM heads of 32, state 16)
to ``repro.models.ssm`` and the reference model the same way, the SSD
scan through its sequential oracle on both sides, at a prompt length
that no chunk of 64 divides; and a hybrid ("mamba2", "attn") pattern with
``d_ff > 0``, where only the attention layer carries an MLP.

Tolerances: layer outputs and caches ``atol = rtol = 2e-5`` (the
reference's own float32 kernel bound); logits ``atol = rtol = 1e-4``.
The largest logit gap measured (prefill and four decode steps, logits
up to 4.3 in magnitude) is 5.2e-6 on the StableLM config and 4.9e-6 on
the local-window variant, 4.8e-6 on the reduced Mamba-2 (logits up to
3.6); cache positions are exact. The RG-LRU layers' states (conv buffer
and float32 hidden state) are held to the layer tolerance: the port's
doubling scan and XLA's associative scan group their sums differently.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import layers as jl
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ARCH_IDS, PORTED, WAITING
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def asdict_ref(cfg) -> dict:
    """``cfg``'s fields that the reference's ``ArchConfig`` has, as
    ``dataclasses.asdict``; the port's own fields (hybrid stacks and
    their experts) must hold their defaults there."""
    ref_fields = {f.name for f in dataclasses.fields(JArchConfig)}
    out = dataclasses.asdict(cfg)
    for f in dataclasses.fields(cfg):
        if f.name not in ref_fields:
            assert out.pop(f.name) == f.default, f.name
    return out


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy() \
            if x.is_floating_point() else x.detach().cpu().numpy()
    return np.asarray(x)


def t_of(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def cfg_pair(local: bool = False):
    """(reference cfg, port cfg): reduced StableLM-3B, or its variant
    with ("local", "attn") layers and an 8-token window, so the local
    layer's ring wraps both in prefill and in decode."""
    jc = j_reduced(j_get_config("stablelm_3b"))
    tc = reduced(get_config("stablelm_3b"))
    if local:
        jc = dataclasses.replace(jc, layer_pattern=("local", "attn"),
                                 window=8)
        tc = dataclasses.replace(tc, layer_pattern=("local", "attn"),
                                 window=8)
    return jc, tc


def mamba_pair(hybrid: bool = False):
    """(reference cfg, port cfg): reduced Mamba2-370m, or a hybrid
    ("mamba2", "attn") variant with d_ff 64, where the attention layer
    carries an MLP and the Mamba-2 layer does not."""
    jc = j_reduced(j_get_config("mamba2_370m"))
    tc = reduced(get_config("mamba2_370m"))
    if hybrid:
        change = dict(layer_pattern=("mamba2", "attn"), d_ff=64)
        jc = dataclasses.replace(jc, **change)
        tc = dataclasses.replace(tc, **change)
    return jc, tc


#: the expert-free decoders ported in slice 6 ("@sw": Gemma2's CONFIG_SW)
DECODERS = ["recurrentgemma_2b", "gemma2_27b", "gemma2_27b@sw",
            "phi3_medium_14b", "chameleon_34b", "nemotron_4_340b"]
#: the reference's param_count of each (printed by it on the CPU)
PARAMS = {"recurrentgemma_2b": 2_658_736_640,
          "gemma2_27b": 27_226_704_384, "gemma2_27b@sw": 27_226_704_384,
          "phi3_medium_14b": 14_659_507_200,
          "chameleon_34b": 34_293_436_416,
          "nemotron_4_340b": 341_029_195_776}


def published_pair(arch: str):
    """(reference cfg, port cfg) as published; "gemma2_27b@sw" is each
    package's ``gemma2_27b.CONFIG_SW``."""
    if arch.endswith("@sw"):
        name = arch.removesuffix("@sw")
        return (importlib.import_module(f"repro.configs.{name}").CONFIG_SW,
                importlib.import_module(
                    f"repro_torch.configs.{name}").CONFIG_SW)
    return j_get_config(arch), get_config(arch)


def decoder_pair(arch: str):
    """(reference cfg, port cfg) reduced: 2 layers (RecurrentGemma one
    (rglru, rglru, local) period), d_model 256, 4 heads, window 64."""
    jc, tc = published_pair(arch)
    return j_reduced(jc), reduced(tc)


def random_gates(tree: dict, seed: int = 7) -> dict:
    """``tree`` (a reference ``init_params`` pytree with numpy leaves) with
    every RG-LRU mixer's gates and Λ redrawn: w_a, w_x ~ N(0, 1), b_a,
    b_x ~ N(0, 0.25), Λ ~ U(-9, -4.4) (the init's range)."""
    rng = np.random.default_rng(seed)

    def redraw(layer):
        mixer = layer.get("mixer", {})
        if "lam" in mixer:
            for key, scale in (("w_a", 1.0), ("w_x", 1.0), ("b_a", 0.5),
                               ("b_x", 0.5)):
                mixer[key] = (rng.normal(size=mixer[key].shape) * scale) \
                    .astype(np.float32)
            mixer["lam"] = rng.uniform(-9, -4.4, mixer["lam"].shape) \
                .astype(np.float32)
    for layer in tree.get("blocks", {}).values():
        redraw(layer)
    for layer in tree.get("remainder", []):
        redraw(layer)
    return tree


def decoder_params(jc, tc):
    """Reference weights from PRNGKey(0) (RG-LRU gates redrawn), as a jax
    pytree and the port's parameters."""
    tree = random_gates(jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jc)))
    return (jax.tree.map(jnp.asarray, tree),
            model_params_from_numpy(tree, tc, device="cpu"))


def params_pair(jc, tc):
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    return jp, tp


def jax_layer_caches(cache: dict, cfg) -> list:
    """The reference's stacked cache as a list of per-layer dicts."""
    out = []
    for p in range(cfg.n_periods):
        for j in range(cfg.period):
            out.append({k: np.asarray(v[p])
                        for k, v in cache["blocks"][f"layer{j}"].items()})
    return out + [{k: np.asarray(v) for k, v in c.items()}
                  for c in cache.get("remainder", [])]


# ------------------------------------------------------------- configs --
class TestConfigs:
    def test_stablelm_matches_the_reference_config(self):
        assert asdict_ref(get_config("stablelm_3b")) == \
            dataclasses.asdict(j_get_config("stablelm_3b"))
        assert asdict_ref(reduced(get_config("stablelm-3b"))) == \
            dataclasses.asdict(j_reduced(j_get_config("stablelm_3b")))

    def test_every_reference_arch_is_ported_or_waiting(self):
        assert sorted(PORTED + tuple(WAITING)) == sorted(ARCH_IDS)

    def test_param_count_matches_the_reference(self):
        for cfg, jcfg in ((get_config("stablelm_3b"),
                           j_get_config("stablelm_3b")),
                          cfg_pair()[::-1]):
            assert tm.param_count(cfg) == jm.param_count(jcfg)

    def test_mamba2_matches_the_reference_config(self):
        assert asdict_ref(get_config("mamba2_370m")) == \
            dataclasses.asdict(j_get_config("mamba2_370m"))
        assert asdict_ref(reduced(get_config("mamba2-370m"))) == \
            dataclasses.asdict(j_reduced(j_get_config("mamba2_370m")))

    def test_mamba2_param_count_matches_the_reference(self):
        for cfg, jcfg in ((get_config("mamba2_370m"),
                           j_get_config("mamba2_370m")),
                          mamba_pair()[::-1], mamba_pair(True)[::-1]):
            assert tm.param_count(cfg) == jm.param_count(jcfg)
        assert tm.param_count(get_config("mamba2_370m")) == 368_338_432

    def test_every_architecture_is_ported(self):
        assert WAITING == {}
        assert sorted(PORTED) == sorted(ARCH_IDS)

    @pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b",
                                      "whisper_small"])
    def test_moe_and_encdec_configs_match_the_reference(self, arch):
        """Field for field, published and reduced, with equal
        ``param_count`` of the reduced configs; the full configs' counts
        are held in ``test_torch_moe.py``."""
        tc, jc = get_config(arch), j_get_config(arch)
        assert asdict_ref(tc) == dataclasses.asdict(jc)
        assert asdict_ref(reduced(tc)) == \
            dataclasses.asdict(j_reduced(jc))
        assert tm.param_count(reduced(tc)) == jm.param_count(j_reduced(jc))
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert get_config(arch.replace("_", "-")) is mod.CONFIG

    def test_unknown_layer_kind_raises(self):
        cfg = dataclasses.replace(cfg_pair()[1], layer_pattern=("conv",))
        with pytest.raises(ValueError, match="unknown layer kind"):
            tm.init_params(cfg, device="meta")

    @pytest.mark.parametrize("arch", DECODERS)
    def test_decoder_config_matches_the_reference(self, arch):
        """Field for field, published and reduced, with equal
        ``param_count`` (computed on the meta device, no allocation)."""
        jc, tc = published_pair(arch)
        assert asdict_ref(tc) == dataclasses.asdict(jc)
        assert asdict_ref(reduced(tc)) == \
            dataclasses.asdict(j_reduced(jc))
        assert tm.param_count(tc) == jm.param_count(jc) == PARAMS[arch]
        assert tm.param_count(reduced(tc)) == jm.param_count(j_reduced(jc))

    @pytest.mark.parametrize("arch", [a for a in DECODERS if "@" not in a])
    def test_get_config_returns_the_module_config(self, arch):
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert get_config(arch) is mod.CONFIG
        assert get_config(arch.replace("_", "-")) is mod.CONFIG


# ---------------------------------------------------------------- init --
class TestInit:
    def test_seeded_init_is_reproducible_and_shaped_like_the_reference(self):
        jc, tc = cfg_pair()
        a = tm.init_params(tc, seed=3, device="cpu")
        b = tm.init_params(tc, seed=3, device="cpu")
        c = tm.init_params(tc, seed=4, device="cpu")
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a["embed"], c["embed"])
        jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                     jc))
        back = model_params_from_numpy(jp, tc, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), back) == \
            jax.tree.map(lambda t: tuple(t.shape), a)

    def test_init_scales_follow_the_reference(self):
        """Normal(0, 1/fan_in) weights, LayerNorm scale 1 and bias 0."""
        tc = reduced(get_config("stablelm_3b"))
        p = tm.init_params(tc, seed=0, device="cpu")
        d = tc.d_model
        assert abs(p["embed"].std().item() - d ** -0.5) < 0.05 * d ** -0.5
        wo = p["layers"][0]["mlp"]["wo"]
        assert abs(wo.std().item() - tc.d_ff ** -0.5) < 0.05 * tc.d_ff ** -0.5
        assert torch.equal(p["final_norm"]["scale"], torch.ones(d))
        assert torch.equal(p["final_norm"]["bias"], torch.zeros(d))


class TestConverter:
    def tree(self):
        jc, tc = cfg_pair()
        return jax.tree.map(np.asarray, jm.init_params(
            jax.random.PRNGKey(0), jc)), tc

    def test_missing_leaf_raises(self):
        tree, tc = self.tree()
        del tree["blocks"]["layer0"]["attn"]["wv"]
        with pytest.raises(ValueError, match="missing"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_extra_leaf_raises(self):
        tree, tc = self.tree()
        tree["final_norm"]["gain"] = np.ones(tc.d_model, np.float32)
        with pytest.raises(ValueError, match="unexpected"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_wrong_shape_raises(self):
        tree, tc = self.tree()
        tree["lm_head"] = tree["lm_head"][:, :-1]
        with pytest.raises(ValueError, match="shape"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_unstacked_block_raises(self):
        tree, tc = self.tree()
        tree["blocks"]["layer0"]["norm1"]["scale"] = np.ones(
            tc.d_model, np.float32)
        with pytest.raises(ValueError, match="stacked"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_layers_unroll_in_order(self):
        tree, tc = self.tree()
        got = model_params_from_numpy(tree, tc, device="cpu")
        for p in range(tc.n_periods):
            np.testing.assert_array_equal(
                np_of(got["layers"][p]["attn"]["wq"]),
                tree["blocks"]["layer0"]["attn"]["wq"][p])


# -------------------------------------------------------------- layers --
class TestLayers:
    rng = staticmethod(lambda seed: np.random.default_rng(seed))

    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    def test_norms(self, kind):
        rng = self.rng(10)
        x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
        params = {"scale": rng.normal(size=64).astype(np.float32)}
        if kind == "layernorm":
            params["bias"] = rng.normal(size=64).astype(np.float32)
        want = jl.apply_norm(kind, jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x))
        got = tl.apply_norm(kind, jax.tree.map(t_of, params), t_of(x))
        np.testing.assert_allclose(np_of(got), np.asarray(want), **LAYER_TOL)

    @pytest.mark.parametrize("d,theta", [(64, 10000.0), (80, 10000.0),
                                         (32, 500000.0)])
    def test_rope(self, d, theta):
        rng = self.rng(11)
        x = rng.normal(size=(2, 40, 3, d)).astype(np.float32)
        pos = rng.integers(0, 4000, (2, 40)).astype(np.int32)
        want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tl.rope(t_of(x), t_of(pos), theta)
        np.testing.assert_allclose(np_of(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)

    @pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
    def test_mlp(self, kind):
        rng = self.rng(12)
        d, f = 32, 48
        params = {"wi": rng.normal(size=(d, f)) / d ** 0.5,
                  "wo": rng.normal(size=(f, d)) / f ** 0.5}
        if kind in ("swiglu", "geglu"):
            params["wg"] = rng.normal(size=(d, f)) / d ** 0.5
        params = {k: v.astype(np.float32) for k, v in params.items()}
        x = rng.normal(size=(2, 7, d)).astype(np.float32)
        want = jl.mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), kind)
        got = tl.mlp(jax.tree.map(t_of, params), t_of(x), kind)
        np.testing.assert_allclose(np_of(got), np.asarray(want), **LAYER_TOL)

    def test_mlp_init_shapes_match_the_reference(self):
        for kind in tl.MLP_KINDS:
            want = jl.mlp_init(jax.random.PRNGKey(0), 16, 24, kind,
                               jnp.float32)
            got = tl.mlp_init(tl.Init(0, "cpu"), 16, 24, kind, torch.float32)
            assert {k: v.shape for k, v in want.items()} == \
                {k: tuple(v.shape) for k, v in got.items()}

    def attn_case(self, seed, window=0, hkv=2, hd=16, softcap=0.0):
        rng = self.rng(seed)
        d, h = 64, 4
        spec = dict(d_model=d, n_heads=h, n_kv_heads=hkv, head_dim=hd,
                    window=window, softcap=softcap)
        params = {"wq": rng.normal(size=(d, h, hd)) / d ** 0.5,
                  "wk": rng.normal(size=(d, hkv, hd)) / d ** 0.5,
                  "wv": rng.normal(size=(d, hkv, hd)) / d ** 0.5,
                  "wo": rng.normal(size=(h, hd, d)) / (h * hd) ** 0.5}
        params = {k: v.astype(np.float32) for k, v in params.items()}
        return rng, spec, params

    @pytest.mark.parametrize("window,cache_len,hkv", [
        (0, 32, 2), (0, 20, 4), (6, 6, 2), (6, 4, 1)])
    def test_self_attention_prefill_and_decode(self, window, cache_len,
                                               hkv):
        """Prefill of 20 tokens into a ring of ``cache_len`` slots (20
        slots: no wrap; fewer: the newest tokens win), then three decode
        steps into the same ring."""
        rng, spec, params = self.attn_case(13 + cache_len, window, hkv)
        b, s = 2, 20
        x = rng.normal(size=(b, s, spec["d_model"])).astype(np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        jspec, tspec = jl.AttnSpec(**spec), tl.AttnSpec(**spec)
        jp = jax.tree.map(jnp.asarray, params)
        tp = jax.tree.map(t_of, params)
        jy, jc = jl.self_attention_prefill(jp, jspec, jnp.asarray(x),
                                           jnp.asarray(pos), cache_len)
        ty, tc = tl.self_attention_prefill(tp, tspec, t_of(x), t_of(pos),
                                           cache_len, kernels="ref")
        np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
        self.check_cache(tc, jc)
        for step in range(3):
            xd = rng.normal(size=(b, 1, spec["d_model"])).astype(np.float32)
            qp = np.full((b,), s + step, np.int32)
            jy, jc = jl.self_attention_decode(jp, jspec, jnp.asarray(xd), jc,
                                              jnp.asarray(qp))
            ty, tc = tl.self_attention_decode(tp, tspec, t_of(xd), tc,
                                              t_of(qp), kernels="ref")
            np.testing.assert_allclose(np_of(ty), np.asarray(jy),
                                       **LAYER_TOL)
            self.check_cache(tc, jc)

    @staticmethod
    def check_cache(tc, jc):
        np.testing.assert_allclose(np_of(tc["k"]), np.asarray(jc["k"]),
                                   **LAYER_TOL)
        np.testing.assert_allclose(np_of(tc["v"]), np.asarray(jc["v"]),
                                   **LAYER_TOL)
        np.testing.assert_array_equal(np_of(tc["pos"]), np.asarray(jc["pos"]))

    def test_self_attention_softcap_and_scale(self):
        rng, spec, params = self.attn_case(14, softcap=30.0)
        spec["scale"] = 0.1
        x = rng.normal(size=(1, 12, spec["d_model"])).astype(np.float32) * 3
        pos = np.arange(12, dtype=np.int32)[None]
        want = jl.self_attention(jax.tree.map(jnp.asarray, params),
                                 jl.AttnSpec(**spec), jnp.asarray(x),
                                 jnp.asarray(pos))
        got = tl.self_attention(jax.tree.map(t_of, params),
                                tl.AttnSpec(**spec), t_of(x), t_of(pos),
                                kernels="ref")
        np.testing.assert_allclose(np_of(got), np.asarray(want), **LAYER_TOL)

    def test_cuda_kernels_refuse_cpu_tensors(self):
        rng, spec, params = self.attn_case(15)
        x = rng.normal(size=(1, 4, spec["d_model"])).astype(np.float32)
        pos = np.arange(4, dtype=np.int32)[None]
        with pytest.raises(ValueError, match="cuda"):
            tl.self_attention(jax.tree.map(t_of, params),
                              tl.AttnSpec(**spec), t_of(x), t_of(pos))


# --------------------------------------------------------------- model --
@pytest.mark.parametrize("local", [False, True], ids=["attn", "local"])
class TestModel:
    def test_prefill_and_decode_match_the_reference(self, local):
        jc, tc = cfg_pair(local)
        jp, tp = params_pair(jc, tc)
        b, s = 2, 16
        rng = np.random.default_rng(20)
        tokens = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
        jl_, jcache = jm.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, tcache = tm.prefill(tp, tc, {"tokens": t_of(tokens)},
                                 kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
        for got, want in zip(tcache["layers"], jax_layer_caches(jcache, jc)):
            np.testing.assert_allclose(np_of(got["k"]), want["k"],
                                       **LAYER_TOL)
            np.testing.assert_allclose(np_of(got["v"]), want["v"],
                                       **LAYER_TOL)
            np.testing.assert_array_equal(np_of(got["pos"]), want["pos"])
        pos = np.full((b,), s, np.int32)
        for _ in range(4):
            tok = rng.integers(0, tc.vocab_size, (b,)).astype(np.int32)
            jl_, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                         jnp.asarray(pos))
            tl_, tcache = tm.decode_step(tp, tc, t_of(tok), tcache,
                                         t_of(pos), kernels="ref")
            np.testing.assert_allclose(np_of(tl_), np.asarray(jl_),
                                       **LOGIT_TOL)
            pos = pos + 1
        for got, want in zip(tcache["layers"], jax_layer_caches(jcache, jc)):
            np.testing.assert_array_equal(np_of(got["pos"]), want["pos"])

    def test_forward_matches_the_reference(self, local):
        jc, tc = cfg_pair(local)
        jp, tp = params_pair(jc, tc)
        tokens = np.random.default_rng(21).integers(
            0, tc.vocab_size, (2, 12)).astype(np.int32)
        jl_, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, aux = tm.forward(tp, tc, {"tokens": t_of(tokens)},
                              kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
        assert float(aux) == 0.0

    def test_init_cache_matches_the_reference(self, local):
        jc, tc = cfg_pair(local)
        want = jax_layer_caches(jm.init_cache(jc, 3, 24), jc)
        got = tm.init_cache(tc, 3, 24, device="cpu")["layers"]
        assert len(got) == len(want) == tc.n_layers
        for g, w in zip(got, want):
            for key in ("k", "v", "pos"):
                assert tuple(g[key].shape) == w[key].shape
                np.testing.assert_array_equal(np_of(g[key]), w[key])


def test_layer_kinds_unroll_periods_then_remainder():
    cfg = dataclasses.replace(cfg_pair()[1], n_layers=5,
                              layer_pattern=("local", "attn"))
    assert tt.layer_kinds(cfg) == ["local", "attn", "local", "attn",
                                   "local"]
    p = tm.init_params(cfg, device="meta")
    assert len(p["layers"]) == 5


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step"])
def test_entry_points_own_the_gemm_precision(entry, monkeypatch):
    """Every GEMM of an entry point runs with float32 accumulation (no
    TF32, no reduced-precision bf16 reduction), whatever the caller set;
    the caller's settings are back afterwards."""
    cuda = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(),
             cuda.allow_bf16_reduced_precision_reduction)
    seen = []
    inner = torch.matmul

    def spy(*args, **kwargs):
        seen.append((torch.get_float32_matmul_precision(),
                     cuda.allow_bf16_reduced_precision_reduction))
        return inner(*args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    tc = cfg_pair()[1]
    params = tm.init_params(tc, seed=0, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    try:
        torch.set_float32_matmul_precision("high")
        cuda.allow_bf16_reduced_precision_reduction = True
        if entry == "forward":
            tm.forward(params, tc, {"tokens": tokens}, kernels="ref")
        elif entry == "prefill":
            tm.prefill(params, tc, {"tokens": tokens}, kernels="ref")
        else:
            cache = tm.init_cache(tc, 2, 8, device="cpu")
            tm.decode_step(params, tc, tokens[:, 0], cache,
                           torch.zeros(2, dtype=torch.int32), kernels="ref")
        after = (torch.get_float32_matmul_precision(),
                 cuda.allow_bf16_reduced_precision_reduction)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cuda.allow_bf16_reduced_precision_reduction = saved[1]
    assert seen and set(seen) == {("highest", False)}
    assert after == ("high", True)


# ------------------------------------------------------------ Mamba-2 --
def mixer_pair(seed: int = 0):
    """Reference Mamba-2 block weights (``ssm.init`` from PRNGKey(seed))
    at the reduced config's widths, as jax and torch dicts."""
    jc, tc = mamba_pair()
    jp = jssm.init(jax.random.PRNGKey(seed), jc, jnp.float32)
    tp = jax.tree.map(lambda a: t_of(np.asarray(a)), jp)
    return jc, tc, jp, tp


def ssm_state(rng, cfg, b: int) -> dict:
    dd = tssm.dims(cfg)
    return {"conv": rng.normal(size=(b, dd["conv_w"] - 1, dd["conv_ch"]))
            .astype(np.float32),
            "ssm": rng.normal(size=(b, dd["n_heads"], dd["head_dim"],
                                    dd["state"])).astype(np.float32)}


class TestSSMLayers:
    def test_init_shapes_and_values_follow_the_reference(self):
        jc, tc, jp, _ = mixer_pair()
        got = tssm.init(tl.Init(0, "cpu"), tc, torch.float32)
        assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
            jax.tree.map(lambda t: tuple(t.shape), got)
        for key in ("conv_b", "dt_bias", "a_log", "d_skip"):
            np.testing.assert_allclose(np_of(got[key]), np.asarray(jp[key]),
                                       rtol=1e-6, atol=0)
        assert abs(got["conv_w"].std().item() - 0.1) < 0.01
        bf = tssm.init(tl.Init(0, "cpu"), tc, torch.bfloat16)
        assert {k: v.dtype for k, v in bf.items() if k != "norm"} == {
            "in_proj": torch.bfloat16, "conv_w": torch.bfloat16,
            "conv_b": torch.bfloat16, "dt_bias": torch.float32,
            "a_log": torch.float32, "d_skip": torch.float32,
            "out_proj": torch.bfloat16}

    @pytest.mark.parametrize("with_buf", [False, True])
    def test_causal_conv(self, with_buf):
        jc, tc, jp, tp = mixer_pair()
        rng = np.random.default_rng(30)
        dd = tssm.dims(tc)
        u = rng.normal(size=(2, 9, dd["conv_ch"])).astype(np.float32)
        buf = rng.normal(size=(2, dd["conv_w"] - 1, dd["conv_ch"])) \
            .astype(np.float32) if with_buf else None
        jy, jbuf = jssm._causal_conv(jp["conv_w"], jp["conv_b"],
                                     jnp.asarray(u), None if buf is None
                                     else jnp.asarray(buf))
        ty, tbuf = tssm._causal_conv(tp["conv_w"], tp["conv_b"], t_of(u),
                                     None if buf is None else t_of(buf))
        np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_array_equal(np_of(tbuf), np.asarray(jbuf))
        assert tbuf.is_contiguous()

    @pytest.mark.parametrize("with_state", [False, True])
    def test_forward(self, with_state):
        """A 70-step sequence (no chunk of 64 divides it), from zeros or
        from a given conv buffer and SSM state, with the state after."""
        jc, tc, jp, tp = mixer_pair()
        rng = np.random.default_rng(31)
        x = rng.normal(size=(2, 70, tc.d_model)).astype(np.float32)
        st = ssm_state(rng, tc, 2) if with_state else None
        jy, jst = jssm.forward(jp, jc, jnp.asarray(x),
                               None if st is None else
                               jax.tree.map(jnp.asarray, st),
                               return_state=True)
        ty, tst = tssm.forward(tp, tc, t_of(x), None if st is None else
                               jax.tree.map(t_of, st), return_state=True,
                               kernels="ref")
        np.testing.assert_allclose(np_of(ty), np.asarray(jy), **LAYER_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(np_of(tst[key]),
                                       np.asarray(jst[key]), **LAYER_TOL)
        plain = tssm.forward(tp, tc, t_of(x), None if st is None else
                             jax.tree.map(t_of, st), kernels="ref")
        torch.testing.assert_close(plain, ty, rtol=0, atol=0)

    def test_decode_step_updates_the_state_in_place(self):
        jc, tc, jp, tp = mixer_pair()
        rng = np.random.default_rng(32)
        st = ssm_state(rng, tc, 3)
        jst = jax.tree.map(jnp.asarray, st)
        tst = jax.tree.map(t_of, st)
        conv, ssm_t = tst["conv"], tst["ssm"]
        for _ in range(3):
            x = rng.normal(size=(3, 1, tc.d_model)).astype(np.float32)
            jy, jst = jssm.decode_step(jp, jc, jnp.asarray(x), jst)
            ty, tst = tssm.decode_step(tp, tc, t_of(x), tst, kernels="ref")
            np.testing.assert_allclose(np_of(ty), np.asarray(jy),
                                       **LAYER_TOL)
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(np_of(tst[key]),
                                           np.asarray(jst[key]), **LAYER_TOL)
        assert tst["conv"] is conv and tst["ssm"] is ssm_t

    def test_prefill_then_decode_continues_the_sequence(self):
        """forward over 40 steps with the state out, then decode steps,
        equals forward over the longer sequence at each new step."""
        _, tc, _, tp = mixer_pair()
        rng = np.random.default_rng(33)
        x = t_of(rng.normal(size=(2, 43, tc.d_model)).astype(np.float32))
        whole = tssm.forward(tp, tc, x, kernels="ref")
        _, st = tssm.forward(tp, tc, x[:, :40], return_state=True,
                             kernels="ref")
        for t in range(40, 43):
            y, st = tssm.decode_step(tp, tc, x[:, t:t + 1], st,
                                     kernels="ref")
            np.testing.assert_allclose(np_of(y), np_of(whole[:, t:t + 1]),
                                       **LAYER_TOL)


@pytest.mark.parametrize("hybrid", [False, True], ids=["mamba2", "hybrid"])
class TestMamba2Model:
    def test_prefill_and_decode_match_the_reference(self, hybrid):
        jc, tc = mamba_pair(hybrid)
        jp, tp = params_pair(jc, tc)
        b, s = 2, 70
        rng = np.random.default_rng(40)
        tokens = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
        jl_, jcache = jm.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, tcache = tm.prefill(tp, tc, {"tokens": t_of(tokens)},
                                 kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
        self.check_caches(tcache, jcache, jc)
        pos = np.full((b,), s, np.int32)
        for _ in range(4):
            tok = rng.integers(0, tc.vocab_size, (b,)).astype(np.int32)
            jl_, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                         jnp.asarray(pos))
            tl_, tcache = tm.decode_step(tp, tc, t_of(tok), tcache,
                                         t_of(pos), kernels="ref")
            np.testing.assert_allclose(np_of(tl_), np.asarray(jl_),
                                       **LOGIT_TOL)
            pos = pos + 1
        self.check_caches(tcache, jcache, jc)

    @staticmethod
    def check_caches(tcache, jcache, jc):
        for got, want in zip(tcache["layers"], jax_layer_caches(jcache, jc)):
            assert set(got) == set(want)
            for key in want:
                if key == "pos":
                    np.testing.assert_array_equal(np_of(got[key]), want[key])
                else:
                    np.testing.assert_allclose(np_of(got[key]), want[key],
                                               **LAYER_TOL)

    def test_forward_matches_the_reference(self, hybrid):
        jc, tc = mamba_pair(hybrid)
        jp, tp = params_pair(jc, tc)
        tokens = np.random.default_rng(41).integers(
            0, tc.vocab_size, (2, 20)).astype(np.int32)
        jl_, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, _ = tm.forward(tp, tc, {"tokens": t_of(tokens)}, kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)

    def test_init_cache_matches_the_reference(self, hybrid):
        jc, tc = mamba_pair(hybrid)
        want = jax_layer_caches(jm.init_cache(jc, 3, 24), jc)
        got = tm.init_cache(tc, 3, 24, device="cpu")["layers"]
        assert len(got) == len(want) == tc.n_layers
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                assert tuple(g[key].shape) == w[key].shape
                assert str(g[key].dtype).split(".")[1] == str(w[key].dtype)
                np.testing.assert_array_equal(np_of(g[key]), w[key])

    def test_only_attention_layers_carry_an_mlp(self, hybrid):
        jc, tc = mamba_pair(hybrid)
        p = tm.init_params(tc, device="meta")
        for layer, kind in zip(p["layers"], tt.layer_kinds(tc)):
            assert ("mlp" in layer) == ("norm2" in layer) == \
                (kind == "attn")
            assert ("mixer" in layer) == (kind == "mamba2")


def test_mamba2_layer_ignores_d_ff():
    """The reference's ``_has_mlp`` rule: a ("mamba2",) pattern at
    d_ff > 0 has no MLP anywhere, in the weights and in the pass."""
    jc, tc = mamba_pair()
    jc, tc = (dataclasses.replace(c, d_ff=128) for c in (jc, tc))
    assert tm.param_count(tc) == jm.param_count(jc) == \
        tm.param_count(mamba_pair()[1])
    jp, tp = params_pair(jc, tc)
    assert all(set(layer) == {"norm1", "mixer"} for layer in tp["layers"])
    tokens = np.random.default_rng(42).integers(
        0, tc.vocab_size, (1, 12)).astype(np.int32)
    jl_, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    tl_, _ = tm.forward(tp, tc, {"tokens": t_of(tokens)}, kernels="ref")
    np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)


# ------------------------------------------------ expert-free decoders --
def check_layer_caches(tcache, jcache, jc):
    """Every layer's cache against the reference's: K/V rings and RG-LRU
    states within the layer tolerance, positions exact."""
    want_layers = jax_layer_caches(jcache, jc)
    assert len(tcache["layers"]) == len(want_layers) == jc.n_layers
    for got, want in zip(tcache["layers"], want_layers):
        assert set(got) == set(want)
        for key in want:
            if key == "pos":
                np.testing.assert_array_equal(np_of(got[key]), want[key])
            else:
                np.testing.assert_allclose(np_of(got[key]), want[key],
                                           **LAYER_TOL)


@pytest.mark.parametrize("arch", DECODERS)
class TestDecoders:
    def test_prefill_and_decode_match_the_reference(self, arch):
        jc, tc = decoder_pair(arch)
        jp, tp = decoder_params(jc, tc)
        b, s = 2, 80
        rng = np.random.default_rng(50)
        tokens = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
        jl_, jcache = jm.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, tcache = tm.prefill(tp, tc, {"tokens": t_of(tokens)},
                                 kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
        check_layer_caches(tcache, jcache, jc)
        pos = np.full((b,), s, np.int32)
        for _ in range(4):
            tok = rng.integers(0, tc.vocab_size, (b,)).astype(np.int32)
            jl_, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                         jnp.asarray(pos))
            tl_, tcache = tm.decode_step(tp, tc, t_of(tok), tcache,
                                         t_of(pos), kernels="ref")
            np.testing.assert_allclose(np_of(tl_), np.asarray(jl_),
                                       **LOGIT_TOL)
            pos = pos + 1
        check_layer_caches(tcache, jcache, jc)

    def test_forward_matches_the_reference(self, arch):
        jc, tc = decoder_pair(arch)
        jp, tp = decoder_params(jc, tc)
        tokens = np.random.default_rng(51).integers(
            0, tc.vocab_size, (2, 80)).astype(np.int32)
        jl_, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
        tl_, aux = tm.forward(tp, tc, {"tokens": t_of(tokens)},
                              kernels="ref")
        np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
        assert float(aux) == 0.0

    def test_init_cache_matches_the_reference(self, arch):
        jc, tc = decoder_pair(arch)
        want = jax_layer_caches(jm.init_cache(jc, 3, 24), jc)
        got = tm.init_cache(tc, 3, 24, device="cpu")["layers"]
        assert len(got) == len(want) == tc.n_layers
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                assert tuple(g[key].shape) == w[key].shape
                assert str(g[key].dtype).split(".")[1] == str(w[key].dtype)
                np.testing.assert_array_equal(np_of(g[key]), w[key])

    def test_layers_carry_the_reference_blocks(self, arch):
        """Attention and RG-LRU layers carry an MLP; the mixer dict of an
        RG-LRU layer holds the reference's leaves."""
        jc, tc = decoder_pair(arch)
        p = tm.init_params(tc, device="meta")
        for layer, kind in zip(p["layers"], tt.layer_kinds(tc)):
            assert "mlp" in layer and "norm2" in layer
            assert ("mixer" in layer) == (kind == "rglru")
            assert ("attn" in layer) == (kind in tt.ATTN_KINDS)
            if kind == "rglru":
                assert set(layer["mixer"]) == {
                    "in_proj", "conv_w", "conv_b", "w_a", "b_a", "w_x",
                    "b_x", "lam", "out_proj"}


def test_recurrentgemma_remainder_layers_carry_across():
    """26 = 8 x 3 + 2: at 5 layers (one period, then an (rglru, rglru)
    remainder) the converter unrolls the stacked period and the
    remainder list in order, leaf for leaf, and the model matches the
    reference."""
    jc, tc = decoder_pair("recurrentgemma_2b")
    jc, tc = (dataclasses.replace(c, n_layers=5) for c in (jc, tc))
    assert tt.layer_kinds(tc) == ["rglru", "rglru", "local", "rglru",
                                  "rglru"]
    jp, tp = decoder_params(jc, tc)
    np.testing.assert_array_equal(
        np_of(tp["layers"][1]["mixer"]["lam"]),
        np.asarray(jp["blocks"]["layer1"]["mixer"]["lam"][0]))
    np.testing.assert_array_equal(
        np_of(tp["layers"][4]["mixer"]["w_a"]),
        np.asarray(jp["remainder"][1]["mixer"]["w_a"]))
    tokens = np.random.default_rng(52).integers(
        0, tc.vocab_size, (2, 70)).astype(np.int32)
    jl_, jcache = jm.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
    tl_, tcache = tm.prefill(tp, tc, {"tokens": t_of(tokens)}, kernels="ref")
    np.testing.assert_allclose(np_of(tl_), np.asarray(jl_), **LOGIT_TOL)
    check_layer_caches(tcache, jcache, jc)


def test_head_is_upcast_in_blocks(monkeypatch):
    """A head wider than ``HEAD_BLOCK`` elements gives the logits of the
    whole head's float32 GEMM, tied or not (each logit is its own
    column's sum; ``atol = rtol = 1e-6`` allows the GEMM another
    blocking)."""
    for arch in ("gemma2_27b", "nemotron_4_340b"):
        _, tc = decoder_pair(arch)
        params = tm.init_params(tc, seed=0, device="cpu")
        x = torch.randn((2, 3, tc.d_model),
                        generator=torch.Generator().manual_seed(9))
        whole = tt._logits(params, tc, x)
        monkeypatch.setattr(tt, "HEAD_BLOCK", 100 * tc.d_model + 7)
        blocks = tt._logits(params, tc, x)
        monkeypatch.undo()
        assert blocks.shape == whole.shape == (2, 3, tc.vocab_size)
        torch.testing.assert_close(blocks, whole, atol=1e-6, rtol=1e-6)


def test_large_weights_are_drawn_in_row_blocks(monkeypatch):
    """A weight above ``Init.DRAW_BLOCK`` elements, bf16 or float32, is
    drawn a block of rows at a time: seeded (the same seed, the same
    bits), Normal(0, std^2), and its first block is the first float32
    draw, scaled and cast. A weight within ``DRAW_BLOCK`` is one draw."""
    monkeypatch.setattr(tl.Init, "DRAW_BLOCK", 64 * 48 + 5)
    for dtype in (torch.bfloat16, torch.float32):
        w = tl.Init(3, "cpu").normal((1000, 64), 0.5, dtype)
        again = tl.Init(3, "cpu").normal((1000, 64), 0.5, dtype)
        assert w.shape == (1000, 64) and w.dtype == dtype
        assert torch.equal(w, again)
        assert abs(w.float().std().item() - 0.5) < 0.02
        first = torch.randn((48, 64),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.float32).mul_(0.5).to(dtype)
        assert torch.equal(w[:48], first)
    whole = tl.Init(3, "cpu").normal((40, 64), 0.5, torch.float32)
    direct = torch.randn((40, 64), generator=torch.Generator()
                         .manual_seed(3)).mul_(0.5)
    assert torch.equal(whole, direct)
