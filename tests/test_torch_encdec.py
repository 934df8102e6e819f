"""The port's encoder-decoder (``repro_torch.models.encdec``, Whisper)
against the JAX package's, on the CPU.

The reduced ``whisper_small`` (2 encoder and 2 decoder layers, d_model
256, 4 heads of 64, GELU, LayerNorm, a 448-slot decoder ring) runs in
float32 through both packages on the same inputs: frames and tokens
drawn with numpy from stated seeds, weights drawn by the reference's
``init_params`` from ``jax.random.PRNGKey(0)`` and carried across by
``convert.model_params_from_numpy``; the port runs the plain versions of
its attention kernels (``kernels="ref"``). ``encode``, ``forward``,
``prefill`` and 16 ``decode_step``s are held within ``atol = rtol =
1e-4``; cross K/V and the self-attention ring within ``2e-5``, its
positions exactly. Every decoded token gets the sinusoid of position 0,
as in the reference (``test_decode_adds_the_position_0_sinusoid``).

The reference's ``ServingEngine.generate`` cannot serve this
architecture (it hands the prefill ``{"embeddings": ...}`` and the
encoder-decoder reads ``batch["frames"]``); the port's refuses it the
same way, and serving goes through ``model.prefill`` and
``model.decode_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models import model as jm
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.serving import ServingEngine
from test_torch_models import asdict_ref, np_of, t_of

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
FRAMES = 40                    # encoder frames in the tests
CACHE_KEYS = {"k": "self_k", "v": "self_v", "pos": "self_pos",
              "cross_k": "cross_k", "cross_v": "cross_v"}


@pytest.fixture(scope="module")
def whisper():
    """(reference cfg, reference params, port cfg, port params)."""
    jc = j_reduced(j_get_config("whisper_small"))
    tc = reduced(get_config("whisper_small"))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    return jc, jp, tc, tp


def inputs(seed: int, cfg, b: int = 2, t: int = 5):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, FRAMES, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": t_of(frames), "tokens": t_of(tokens)})


def check_cache(tcache, jcache, n_layers):
    assert len(tcache["layers"]) == n_layers
    for i, layer in enumerate(tcache["layers"]):
        assert set(layer) == set(CACHE_KEYS)
        for key, jkey in CACHE_KEYS.items():
            want = np.asarray(jcache[jkey][i])
            assert tuple(layer[key].shape) == want.shape
            if key == "pos":
                np.testing.assert_array_equal(np_of(layer[key]), want)
            else:
                np.testing.assert_allclose(np_of(layer[key]), want,
                                           **LAYER_TOL)


def test_config_matches_the_reference():
    assert asdict_ref(get_config("whisper_small")) == \
        dataclasses.asdict(j_get_config("whisper_small"))


@pytest.mark.parametrize("length,d", [(1, 8), (40, 256), (1500, 768)])
def test_sinusoidal_positions(length, d):
    """Each angle is a position times a frequency from float32 ``exp``,
    which XLA and torch may round one ulp (at most 2^-23 below 1) apart:
    the angles, and so the sines, may differ by up to ``length`` ulps."""
    got = tl.sinusoidal_positions(length, d)
    assert got.shape == (length, d) and got.dtype == torch.float32
    np.testing.assert_allclose(
        np_of(got), np.asarray(jl.sinusoidal_positions(length, d)),
        atol=1e-6 + length * 2.0 ** -23, rtol=0)


def test_encode_matches_the_reference(whisper):
    jc, jp, tc, tp = whisper
    jb, tb = inputs(70, tc)
    want = je.encode(jp, jc, jb["frames"])
    got = te.encode(tp, tc, tb["frames"], kernels="ref")
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LOGIT_TOL)


def test_forward_matches_the_reference(whisper):
    jc, jp, tc, tp = whisper
    jb, tb = inputs(71, tc, t=9)
    want, jaux = jm.forward(jp, jc, jb)
    got, aux = tm.forward(tp, tc, tb, kernels="ref")
    assert got.shape == (2, 9, tc.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_match_the_reference(whisper):
    """A 4-token prompt against 40 frames, then 16 decode steps: logits
    every step, the cache after prefill and after the last step."""
    jc, jp, tc, tp = whisper
    jb, tb = inputs(72, tc, t=4)
    jlog, jcache = jm.prefill(jp, jc, jb)
    tlog, tcache = tm.prefill(tp, tc, tb, kernels="ref")
    np.testing.assert_allclose(np_of(tlog), np.asarray(jlog), **LOGIT_TOL)
    check_cache(tcache, jcache, tc.n_layers)
    assert tcache["layers"][0]["k"].shape[1] == tc.max_decoder_len
    rng = np.random.default_rng(73)
    pos = np.full((2,), 4, np.int32)
    for _ in range(16):
        tok = rng.integers(0, tc.vocab_size, (2,)).astype(np.int32)
        jlog, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                                      jnp.asarray(pos))
        tlog, tcache = tm.decode_step(tp, tc, t_of(tok), tcache, t_of(pos),
                                      kernels="ref")
        np.testing.assert_allclose(np_of(tlog), np.asarray(jlog),
                                   **LOGIT_TOL)
        pos = pos + 1
    check_cache(tcache, jcache, tc.n_layers)
    want_pos = np.full((2, tc.max_decoder_len), -1)
    want_pos[:, :20] = np.arange(20)
    for layer in tcache["layers"]:
        np.testing.assert_array_equal(np_of(layer["pos"]), want_pos)


def test_decode_adds_the_position_0_sinusoid(whisper):
    """From an empty self ring, one decode step at position 0 and one at
    position 300 give the same logits in both packages: the token's
    embedding gets the sinusoid of position 0 whatever its position, and
    the only valid slot is its own."""
    jc, jp, tc, tp = whisper
    jb, tb = inputs(74, tc, t=1)
    _, jcache = jm.prefill(jp, jc, jb)
    _, tcache = tm.prefill(tp, tc, tb, kernels="ref")
    tok = np.array([3, 7], np.int32)
    out = {}
    for p in (0, 300):
        pos = np.full((2,), p, np.int32)
        jfresh = dict(jcache, self_pos=jnp.full_like(jcache["self_pos"], -1))
        tfresh = {"layers": [dict(c, k=c["k"].clone(), v=c["v"].clone(),
                                  pos=torch.full_like(c["pos"], -1))
                             for c in tcache["layers"]]}
        jlog, _ = jm.decode_step(jp, jc, jnp.asarray(tok), jfresh,
                                 jnp.asarray(pos))
        tlog, _ = tm.decode_step(tp, tc, t_of(tok), tfresh, t_of(pos),
                                 kernels="ref")
        np.testing.assert_allclose(np_of(tlog), np.asarray(jlog),
                                   **LOGIT_TOL)
        out[p] = np_of(tlog)
    np.testing.assert_allclose(out[0], out[300], atol=1e-5, rtol=1e-5)


def test_cross_kv_matches_the_reference(whisper):
    jc, jp, tc, tp = whisper
    enc = np.random.default_rng(75).normal(
        size=(2, FRAMES, tc.d_model)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["dec_blocks"]["cross_attn"])
    spec = dict(d_model=tc.d_model, n_heads=tc.n_heads,
                n_kv_heads=tc.n_kv_heads, head_dim=tc.head_dim,
                causal=False, use_rope=False)
    jk, jv = jl.cross_kv(jattn, jl.AttnSpec(**spec), jnp.asarray(enc))
    tk, tv = tl.cross_kv(tp["dec_layers"][0]["cross_attn"],
                         tl.AttnSpec(**spec), t_of(enc))
    np.testing.assert_allclose(np_of(tk), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(np_of(tv), np.asarray(jv), **LAYER_TOL)


@pytest.mark.parametrize("sq", [1, 4, 7])
def test_cross_attention_at_sq_ne_skv(whisper, sq):
    """Sq queries against 40 encoder frames through the plain version:
    the port's ``cross_attention`` (query positions broadcast to
    ``enc_len - 1``) against the reference's, and the plain version with
    those positions against it with none (suffix-aligned): with no
    causal mask and no window no mask depends on a position, so the
    card's suffix-aligned kernel computes the same."""
    jc, jp, tc, tp = whisper
    rng = np.random.default_rng(76 + sq)
    x = rng.normal(size=(2, sq, tc.d_model)).astype(np.float32)
    ek = rng.normal(size=(2, FRAMES, tc.n_kv_heads, tc.head_dim)) \
        .astype(np.float32)
    ev = rng.normal(size=ek.shape).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[1], jp["dec_blocks"]["cross_attn"])
    spec = dict(d_model=tc.d_model, n_heads=tc.n_heads,
                n_kv_heads=tc.n_kv_heads, head_dim=tc.head_dim,
                causal=False, use_rope=False)
    want = jl.cross_attention(jattn, jl.AttnSpec(**spec), jnp.asarray(x),
                              jnp.asarray(ek), jnp.asarray(ev))
    got = tl.cross_attention(tp["dec_layers"][1]["cross_attn"],
                             tl.AttnSpec(**spec), t_of(x), t_of(ek),
                             t_of(ev), kernels="ref")
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LAYER_TOL)
    q = t_of(rng.normal(size=(2, sq, tc.n_heads, tc.head_dim))
             .astype(np.float32))
    broadcast = torch.full((2, sq), FRAMES - 1, dtype=torch.int32)
    with_pos = ref.flash_attention_ref(q, t_of(ek), t_of(ev), causal=False,
                                       segment_pos=broadcast)
    suffix = ref.flash_attention_ref(q, t_of(ek), t_of(ev), causal=False)
    torch.testing.assert_close(with_pos, suffix, atol=0, rtol=0)


def test_init_cache_matches_the_reference(whisper):
    jc, _, tc, _ = whisper
    want = jm.init_cache(jc, 3, 24)
    got = tm.init_cache(tc, 3, 24, device="cpu")
    assert len(got["layers"]) == tc.n_layers
    for i, layer in enumerate(got["layers"]):
        for key, jkey in CACHE_KEYS.items():
            w = np.asarray(want[jkey][i])
            assert tuple(layer[key].shape) == w.shape
            assert str(layer[key].dtype).split(".")[1] == str(w.dtype)
            np.testing.assert_array_equal(np_of(layer[key]), w)


def test_the_engine_refuses_whisper_like_the_reference(whisper):
    """Both engines hand the prefill ``{"embeddings": prompts}``; the
    encoder-decoder needs ``frames``."""
    jc, jp, tc, tp = whisper
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(KeyError, match="frames"):
        JaxEngine(jc, jp, slots=2, max_len=16).generate(
            jnp.asarray(prompts), steps=2)
    with pytest.raises(KeyError, match="frames"):
        ServingEngine(tc, tp, slots=2, max_len=16, device="cpu",
                      kernels="ref").generate(prompts, steps=2)


class TestConverter:
    def tree(self, whisper):
        jc, jp, tc, _ = whisper
        return jax.tree.map(np.asarray, jp), tc

    def test_layers_unstack_in_order(self, whisper):
        tree, tc = self.tree(whisper)
        got = model_params_from_numpy(tree, tc, device="cpu")
        assert len(got["enc_layers"]) == tc.n_encoder_layers
        assert len(got["dec_layers"]) == tc.n_layers
        for i in range(tc.n_layers):
            np.testing.assert_array_equal(
                np_of(got["enc_layers"][i]["attn"]["wq"]),
                tree["enc_blocks"]["attn"]["wq"][i])
            np.testing.assert_array_equal(
                np_of(got["dec_layers"][i]["cross_attn"]["wk"]),
                tree["dec_blocks"]["cross_attn"]["wk"][i])
        shapes = tm.init_params(tc, device="meta")
        assert jax.tree.map(lambda t: tuple(t.shape), got) == \
            jax.tree.map(lambda t: tuple(t.shape), shapes)

    def test_missing_leaf_raises(self, whisper):
        tree, tc = self.tree(whisper)
        del tree["dec_blocks"]["norm_x"]
        with pytest.raises(ValueError, match="missing"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_extra_leaf_raises(self, whisper):
        tree, tc = self.tree(whisper)
        tree["enc_norm"]["gain"] = np.ones(tc.d_model, np.float32)
        with pytest.raises(ValueError, match="unexpected"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_unstacked_block_raises(self, whisper):
        tree, tc = self.tree(whisper)
        tree["enc_blocks"]["norm1"]["scale"] = np.ones(tc.d_model,
                                                       np.float32)
        with pytest.raises(ValueError, match="stacked"):
            model_params_from_numpy(tree, tc, device="cpu")

    def test_wrong_shape_raises(self, whisper):
        tree, tc = self.tree(whisper)
        tree["lm_head"] = tree["lm_head"][:, :-1]
        with pytest.raises(ValueError, match="shape"):
            model_params_from_numpy(tree, tc, device="cpu")
