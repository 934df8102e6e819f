"""The port's ``ServingEngine`` against the JAX package's, on the CPU.

Both engines run the reduced StableLM-3B config in float32 with the
reference's weights from ``jax.random.PRNGKey(0)`` (carried across by
``model_params_from_numpy``) on prompts drawn with numpy from stated
seeds; the port runs ``device="cpu", kernels="ref"`` (the plain versions
of its attention kernels). Greedy tokens must be equal. Both engine
paths are driven: ``b == slots`` adopts the prefill cache, ``b < slots``
merges it into the engine's; either way the port's attention rings are
``max_len`` deep. The reference's ``b == slots`` path adopts a ring as
deep as the prompt, whose first decode step overwrites the prompt's
first key, so a port's ``b == slots`` wave is held to the reference's
``b < slots`` path on the same prompts (one more slot there), and a full
wave and a second wave to the port's own full forward
(``TestFullWaves``).

The reference's own engine tests (``tests/test_serving.py``) are ported
as well: manual decode, slot management, positions, the partial-batch
merge and idle-slot invariance.

The expert-free decoders of slice 6 (reduced ``recurrentgemma_2b``,
``gemma2_27b`` and its ``@sw`` variant, ``phi3_medium_14b``,
``chameleon_34b``, ``nemotron_4_340b``; ``TestDecoderEngines``) are served
on both paths at a 72-token prompt against their 64-token window, so
every local ring wraps; RecurrentGemma's gates are redrawn in the
reference's weights first (``test_torch_models.random_gates``), and its
RG-LRU states ride both paths beside the KV rings.

The reduced Mamba2-370m is served the same way (``TestMamba2Engine``):
both paths carry its conv buffers and SSM states instead of KV rings, at
a prompt length no chunk of 64 divides.

On a CUDA device the engine replays its decode step as a CUDA graph
bound to tensors it owns. On the CPU (eager steps) the static-buffer
contract is held here (``TestStaticBuffers``): ``current`` and ``pos``
are written in place, an adopted cache is copied into the static one,
and a prompt longer than ``max_len`` is refused where the cache holds
attention rings. The tests marked
``cuda`` hold replayed steps to eager ones on the card, bit for
bit; they need only the port, so the JAX package is imported where it
is installed (the card's machine has none: run ``-m cuda`` there).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as tm
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import (GenerationResult, _merge_batch,
                                        make_decode_fn, make_prefill_fn,
                                        same_layout)

try:
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as j_get_config
    from repro.configs.base import reduced as j_reduced
    from repro.models import model as jm
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.convert import model_params_from_numpy
    from test_torch_models import random_gates
except ImportError:     # the card's machine: only the cuda tests run there
    jax = None

CPU = dict(device="cpu", kernels="ref")


@pytest.fixture(scope="module")
def setup():
    jc = j_reduced(j_get_config("stablelm_3b"))
    tc = reduced(get_config("stablelm_3b"))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    return jc, jp, tc, tp


def prompts(seed: int, b: int, s: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


class TestAgainstTheReferenceEngine:
    @pytest.mark.parametrize("b,s,steps,slots,max_len", [
        (4, 16, 4, 4, 64),      # b == slots: adopts the max_len-deep ring
        (2, 8, 3, 4, 64),       # b < slots: merged into max_len
        (3, 24, 6, 3, 32),      # b == slots, decode past a 24-token prompt
    ])
    def test_greedy_tokens_match(self, setup, b, s, steps, slots, max_len):
        """A ``b == slots`` wave is held to the reference's ``b < slots``
        path (one more slot), which keeps the whole prompt."""
        jc, jp, tc, tp = setup
        p = prompts(b * 100 + s, b, s, tc.vocab_size)
        want = JaxEngine(jc, jp, slots=slots + (b == slots),
                         max_len=max_len) \
            .generate(jnp.asarray(p), steps=steps)
        got = ServingEngine(tc, tp, slots=slots, max_len=max_len, **CPU) \
            .generate(p, steps=steps)
        assert isinstance(got, GenerationResult) and got.steps == steps
        np.testing.assert_array_equal(got.tokens, want.tokens)

    def test_engine_state_matches_after_generate(self, setup):
        jc, jp, tc, tp = setup
        p = prompts(5, 2, 8, tc.vocab_size)
        je = JaxEngine(jc, jp, slots=4, max_len=32)
        te = ServingEngine(tc, tp, slots=4, max_len=32, **CPU)
        je.generate(jnp.asarray(p), steps=3)
        te.generate(p, steps=3)
        np.testing.assert_array_equal(te.pos.numpy(), np.asarray(je.pos))
        np.testing.assert_array_equal(te.current.numpy(),
                                      np.asarray(je.current))
        np.testing.assert_array_equal(te.active, je.active)
        jcache = je.cache["blocks"]["layer0"]
        for i, layer in enumerate(te.cache["layers"]):
            np.testing.assert_array_equal(layer["pos"].numpy(),
                                          np.asarray(jcache["pos"][i]))
            np.testing.assert_allclose(layer["k"].numpy(),
                                       np.asarray(jcache["k"][i]),
                                       atol=2e-5, rtol=2e-5)


class TestServingEngine:
    def test_generate_matches_manual_decode(self, setup):
        _, _, cfg, params = setup
        b, s, steps = 4, 16, 4
        p = torch.from_numpy(prompts(1, b, s, cfg.vocab_size))
        out = ServingEngine(cfg, params, slots=b, max_len=64, **CPU) \
            .generate(p, steps=steps)
        assert out.tokens.shape == (b, steps)
        prefill, decode = make_prefill_fn(cfg, "ref", 64), make_decode_fn(
            cfg, "ref")
        logits, cache = prefill(params, {"tokens": p})
        tok = torch.argmax(logits, -1).to(torch.int32)
        got = [tok.numpy()]
        pos = torch.full((b,), s, dtype=torch.int32)
        for _ in range(steps - 1):
            logits, cache = decode(params, tok, cache, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos = pos + 1
            got.append(tok.numpy())
        np.testing.assert_array_equal(out.tokens, np.stack(got, 1))

    def test_slot_management(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=4, max_len=32, **CPU)
        assert eng.free_slots() == [0, 1, 2, 3]
        eng.admit(1, first_token=5, start_pos=3)
        assert eng.free_slots() == [0, 2, 3] and eng.n_free() == 3
        assert int(eng.current[1]) == 5 and int(eng.pos[1]) == 3
        assert eng.admit_next(first_token=7, start_pos=2) == 0
        eng.release(1)
        eng.release(0)
        assert eng.free_slots() == [0, 1, 2, 3]

    def test_admit_next_full_batch_returns_none(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=2, max_len=16, **CPU)
        assert [eng.admit_next(), eng.admit_next()] == [0, 1]
        assert eng.admit_next() is None

    def test_release_errors_are_loud(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=2, max_len=16, **CPU)
        with pytest.raises(RuntimeError, match="double release"):
            eng.release(0)
        with pytest.raises(IndexError, match="no such slot"):
            eng.release(2)

    def test_decode_steps_advance_positions(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=2, max_len=32, **CPU)
        eng.generate(np.ones((2, 8), np.int32), steps=2)
        assert int(eng.pos[0]) == 8 + 2 - 1

    def test_more_prompts_than_slots_raise(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=2, max_len=32, **CPU)
        with pytest.raises(ValueError, match="slots"):
            eng.generate(np.ones((3, 4), np.int32), steps=1)

    def test_cuda_kernels_refuse_a_cpu_engine(self, setup):
        _, _, cfg, params = setup
        eng = ServingEngine(cfg, params, slots=2, max_len=16,
                            device="cpu", kernels="cuda")
        with pytest.raises(ValueError, match="cuda"):
            eng.generate(np.ones((2, 4), np.int32), steps=1)


class TestPartialBatchMerge:
    def test_generate_with_fewer_prompts_than_slots(self, setup):
        """b < slots exercises _merge_batch: the prefilled cache is
        smaller than the engine cache along BOTH the slot and the
        cache-depth axes."""
        _, _, cfg, params = setup
        p = prompts(2, 2, 8, cfg.vocab_size)
        eng = ServingEngine(cfg, params, slots=4, max_len=64, **CPU)
        out = eng.generate(p, steps=3)
        assert out.tokens.shape == (2, 3)
        assert list(eng.active[:2]) == [True, True]
        assert eng.free_slots() == [2, 3]
        assert tuple(eng.cache["layers"][0]["k"].shape)[:2] == (4, 64)

    def test_idle_slots_do_not_leak_into_active_decode(self, setup):
        """Active sequences decode identically however many idle slots
        share the batch: idle slots carry kv_pos = -1 and are masked out
        of attention entirely."""
        _, _, cfg, params = setup
        p = prompts(3, 2, 8, cfg.vocab_size)
        four = ServingEngine(cfg, params, slots=4, max_len=64, **CPU) \
            .generate(p, steps=4)
        eight = ServingEngine(cfg, params, slots=8, max_len=64, **CPU) \
            .generate(p, steps=4)
        np.testing.assert_array_equal(four.tokens, eight.tokens)

    def test_merge_batch_writes_the_leading_corner(self):
        full = torch.full((4, 6, 2), -1.0)
        new = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
        _merge_batch(full, new)
        assert torch.equal(full[:2, :3], new)
        assert (full[2:] == -1).all() and (full[:, 3:] == -1).all()


@pytest.fixture(scope="module")
def mamba_setup():
    jc = j_reduced(j_get_config("mamba2_370m"))
    tc = reduced(get_config("mamba2_370m"))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    return jc, jp, tc, tp


class TestMamba2Engine:
    @pytest.mark.parametrize("b,s,steps,slots,max_len", [
        (3, 70, 5, 3, 16),      # b == slots: adopts the prefill states
        (2, 70, 5, 4, 64),      # b < slots: merged into the leading slots
    ])
    def test_greedy_tokens_match(self, mamba_setup, b, s, steps, slots,
                                 max_len):
        jc, jp, tc, tp = mamba_setup
        p = prompts(b * 100 + s, b, s, tc.vocab_size)
        want = JaxEngine(jc, jp, slots=slots, max_len=max_len) \
            .generate(jnp.asarray(p), steps=steps)
        got = ServingEngine(tc, tp, slots=slots, max_len=max_len, **CPU) \
            .generate(p, steps=steps)
        np.testing.assert_array_equal(got.tokens, want.tokens)

    def test_states_match_after_generate(self, mamba_setup):
        """b < slots: the prefill's conv buffers and SSM states land in
        the leading slots, the idle slots' stay zero until they decode,
        and after three steps every slot holds the reference's state."""
        jc, jp, tc, tp = mamba_setup
        p = prompts(6, 2, 70, tc.vocab_size)
        je = JaxEngine(jc, jp, slots=4, max_len=32)
        te = ServingEngine(tc, tp, slots=4, max_len=32, **CPU)
        je.generate(jnp.asarray(p), steps=3)
        te.generate(p, steps=3)
        np.testing.assert_array_equal(te.pos.numpy(), np.asarray(je.pos))
        np.testing.assert_array_equal(te.current.numpy(),
                                      np.asarray(je.current))
        jcache = je.cache["blocks"]["layer0"]
        for i, layer in enumerate(te.cache["layers"]):
            assert set(layer) == {"conv", "ssm"}
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(layer[key].numpy(),
                                           np.asarray(jcache[key][i]),
                                           atol=2e-5, rtol=2e-5)

    def test_idle_slots_do_not_leak_into_active_decode(self, mamba_setup):
        _, _, cfg, params = mamba_setup
        p = prompts(7, 2, 20, cfg.vocab_size)
        four = ServingEngine(cfg, params, slots=4, max_len=64, **CPU) \
            .generate(p, steps=4)
        eight = ServingEngine(cfg, params, slots=8, max_len=64, **CPU) \
            .generate(p, steps=4)
        np.testing.assert_array_equal(four.tokens, eight.tokens)

    def test_cuda_kernels_refuse_a_cpu_engine(self, mamba_setup):
        _, _, cfg, params = mamba_setup
        eng = ServingEngine(cfg, params, slots=2, max_len=16,
                            device="cpu", kernels="cuda")
        with pytest.raises(ValueError, match="cuda"):
            eng.generate(np.ones((2, 4), np.int32), steps=1)


def test_param_count_of_the_served_model():
    assert tm.param_count(get_config("stablelm_3b")) == 2_795_443_200


DECODERS = ["recurrentgemma_2b", "gemma2_27b", "gemma2_27b@sw",
            "phi3_medium_14b", "chameleon_34b", "nemotron_4_340b"]


@pytest.fixture(scope="module")
def decoder_setup():
    """arch -> (reference cfg, reference params, port cfg, port params)
    of the reduced ``arch`` ("@sw": Gemma2's CONFIG_SW), each made once
    per module."""
    made = {}

    def get(arch: str):
        if arch not in made:
            name = arch.removesuffix("@sw")
            if arch.endswith("@sw"):
                jc = importlib.import_module(
                    f"repro.configs.{name}").CONFIG_SW
                tc = importlib.import_module(
                    f"repro_torch.configs.{name}").CONFIG_SW
            else:
                jc, tc = j_get_config(name), get_config(name)
            jc, tc = j_reduced(jc), reduced(tc)
            tree = random_gates(jax.tree.map(np.asarray, jm.init_params(
                jax.random.PRNGKey(0), jc)))
            made[arch] = (jc, jax.tree.map(jnp.asarray, tree), tc,
                          model_params_from_numpy(tree, tc, device="cpu"))
        return made[arch]
    return get


@pytest.mark.parametrize("arch", DECODERS)
class TestDecoderEngines:
    @pytest.mark.parametrize("b,s,steps,slots,max_len", [
        (3, 72, 5, 3, 96),      # b == slots: adopts the prefill rings
        (2, 72, 5, 4, 96),      # b < slots: merged into the leading slots
    ], ids=["b_eq_slots", "b_lt_slots"])
    def test_greedy_tokens_match(self, decoder_setup, arch, b, s, steps,
                                 slots, max_len):
        """``b == slots`` is held to the reference's ``b < slots`` path
        (one more slot), as in ``TestAgainstTheReferenceEngine``."""
        jc, jp, tc, tp = decoder_setup(arch)
        p = prompts(b * 100 + s, b, s, tc.vocab_size)
        want = JaxEngine(jc, jp, slots=slots + (b == slots),
                         max_len=max_len) \
            .generate(jnp.asarray(p), steps=steps)
        got = ServingEngine(tc, tp, slots=slots, max_len=max_len, **CPU) \
            .generate(p, steps=steps)
        np.testing.assert_array_equal(got.tokens, want.tokens)

    def test_cuda_kernels_refuse_a_cpu_engine(self, decoder_setup, arch):
        _, _, cfg, params = decoder_setup(arch)
        eng = ServingEngine(cfg, params, slots=2, max_len=16,
                            device="cpu", kernels="cuda")
        with pytest.raises(ValueError, match="cuda"):
            eng.generate(np.ones((2, 4), np.int32), steps=1)


def test_recurrentgemma_states_ride_both_paths(decoder_setup):
    """b < slots: the prefill's RG-LRU states land in the leading slots
    beside the KV rings, and after three steps every slot's state is the
    reference's."""
    jc, jp, tc, tp = decoder_setup("recurrentgemma_2b")
    p = prompts(8, 2, 72, tc.vocab_size)
    je = JaxEngine(jc, jp, slots=4, max_len=96)
    te = ServingEngine(tc, tp, slots=4, max_len=96, **CPU)
    je.generate(jnp.asarray(p), steps=3)
    te.generate(p, steps=3)
    np.testing.assert_array_equal(te.current.numpy(), np.asarray(je.current))
    jcache = je.cache["blocks"]
    for i, layer in enumerate(te.cache["layers"]):
        want = {k: np.asarray(v[0]) for k, v in
                jcache[f"layer{i}"].items()}
        assert set(layer) == set(want)
        for key in want:
            if key == "pos":
                np.testing.assert_array_equal(layer[key].numpy(), want[key])
            else:
                np.testing.assert_allclose(layer[key].numpy(), want[key],
                                           atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ full waves
def full_wave_then_second(cfg, params, second: int, **engine) -> tuple:
    """A full wave of 3 prompts of 8 decoding 12 tokens (keys at
    positions 8 to 18), released, then ``second`` prompts of 6 decoding
    6: (the second wave's tokens, a fresh engine's on its prompts)."""
    eng = ServingEngine(cfg, params, slots=3, max_len=32, **engine)
    p1 = torch.as_tensor(prompts(12, 3, 8, cfg.vocab_size),
                         device=eng.device)
    eng.generate(p1, steps=12)
    for r in range(3):
        eng.release(r)
    p2 = torch.as_tensor(prompts(13, second, 6, cfg.vocab_size),
                         device=eng.device)
    got = eng.generate(p2, steps=6).tokens
    want = ServingEngine(cfg, params, slots=3, max_len=32, **engine) \
        .generate(p2, steps=6).tokens
    return got, want


class TestFullWaves:
    def test_a_full_wave_decodes_past_its_prompt(self, setup):
        """``b == slots``: every greedy token equals the full forward's
        over the prompt and the tokens before it (the prompt's first key
        is never overwritten)."""
        _, _, cfg, params = setup
        b, s, steps = 3, 12, 8
        p = torch.from_numpy(prompts(11, b, s, cfg.vocab_size))
        got = ServingEngine(cfg, params, slots=b, max_len=32, **CPU) \
            .generate(p, steps=steps).tokens
        seq = torch.cat([p, torch.from_numpy(got[:, :-1]).to(p.dtype)], 1)
        logits, _ = tm.forward(params, cfg, {"tokens": seq}, kernels="ref")
        np.testing.assert_array_equal(
            got, logits[:, s - 1:].argmax(-1).numpy())

    @pytest.mark.parametrize("second", [2, 3], ids=["b_lt_slots",
                                                    "b_eq_slots"])
    def test_a_second_wave_never_attends_the_first(self, setup, second):
        """After a full wave decoded past its prompt, a second, shorter
        wave (partial or full) decodes as on a fresh engine: the first
        wave's keys past the new prompts are never attended."""
        _, _, cfg, params = setup
        got, want = full_wave_then_second(cfg, params, second, **CPU)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [2, 3], ids=["b_lt_slots",
                                                "b_eq_slots"])
def test_a_second_wave_never_attends_the_first_through_the_graph(
        cuda_device, second):
    """``TestFullWaves``' second wave on the card, its steps replayed
    from the engine's CUDA graph."""
    cfg = reduced(get_config("stablelm_3b"))
    params = tm.init_params(cfg, seed=0, device=cuda_device)
    got, want = full_wave_then_second(cfg, params, second,
                                      device=cuda_device)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the static buffers
class TestStaticBuffers:
    @pytest.mark.parametrize("b", [2, 4], ids=["b_lt_slots", "b_eq_slots"])
    def test_current_and_pos_stay_in_place(self, setup, b):
        """``generate`` and ``step`` write the engine's own ``current``
        and ``pos``, which hold the reference engine's values (at b ==
        slots, those of its ``b < slots`` path's leading slots)."""
        jc, jp, tc, tp = setup
        p = prompts(40 + b, b, 8, tc.vocab_size)
        je = JaxEngine(jc, jp, slots=4 + (b == 4), max_len=32)
        te = ServingEngine(tc, tp, slots=4, max_len=32, **CPU)
        ptrs = (te.current.data_ptr(), te.pos.data_ptr())
        je.generate(jnp.asarray(p), steps=1)
        te.generate(p, steps=1)
        for k in range(3):
            assert (te.current.data_ptr(), te.pos.data_ptr()) == ptrs
            np.testing.assert_array_equal(te.current.numpy(),
                                          np.asarray(je.current)[:4])
            np.testing.assert_array_equal(te.pos.numpy(),
                                          np.asarray(je.pos)[:4])
            if k < 2:
                np.testing.assert_array_equal(te.step(), je.step()[:4])

    @pytest.mark.parametrize("arch,s,max_len,copied", [
        ("mamba2_370m", 70, 16, True),      # states have no depth
        ("stablelm_3b", 16, 16, True),      # the ring is max_len deep
        ("stablelm_3b", 8, 16, True),       # so is a shorter prompt's
        ("stablelm_3b", 24, 16, None),      # a prompt past max_len: refused
    ], ids=["mamba2", "attn_s_eq_max_len", "attn_s_lt_max_len",
            "attn_s_gt_max_len"])
    def test_an_adopted_cache_binds_to_the_static_one(
            self, setup, mamba_setup, arch, s, max_len, copied):
        """A B == slots wave adopts the prefill cache; the next step's
        binding copies it into the graph's static tensors, since every
        shape matches (attention rings are ``max_len`` deep; Mamba-2
        states have no depth, so a Mamba-2 prompt may be longer). An
        attention model's prompt longer than ``max_len`` is refused before
        any work, and the engine keeps its static cache and graph."""
        _, _, cfg, params = mamba_setup if arch == "mamba2_370m" else setup
        eng = ServingEngine(cfg, params, slots=3, max_len=max_len, **CPU)
        assert eng._bind_cache()
        static = eng.cache
        captured = eng._graph = object()    # stands in for a graph
        if copied is None:
            with pytest.raises(ValueError, match="max_len"):
                eng.generate(prompts(9, 3, s, cfg.vocab_size), steps=1)
            assert eng.cache is static and eng._graph is captured
            assert not eng.active.any()
            return
        eng.generate(prompts(9, 3, s, cfg.vocab_size), steps=1)
        adopted = eng.cache
        assert adopted is not static
        want = tree_map(torch.clone, adopted)
        assert eng._bind_cache()
        assert same_layout(static, adopted)
        assert eng.cache is static and eng._graph is captured
        for got, ref in zip(tree_leaves(static), tree_leaves(want)):
            assert torch.equal(got, ref)

    def test_same_layout(self):
        a = {"layers": [{"k": torch.zeros(2, 3), "pos": torch.zeros(
            2, dtype=torch.int32)}]}
        assert same_layout(a, tree_map(torch.clone, a))
        b = tree_map(torch.clone, a)
        b["layers"][0]["pos"] = b["layers"][0]["pos"].long()
        assert not same_layout(a, b)
        b = tree_map(torch.clone, a)
        b["layers"][0]["k"] = torch.zeros(2, 4)
        assert not same_layout(a, b)
        assert not same_layout(a, {"layers": a["layers"] * 2})
        assert not same_layout(a, {"layers": [{"k": torch.zeros(2, 3)}]})


# ------------------------------------------------- the graph on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written "
                    "kernels run on the card only")
    return torch.device("cuda", 0)


GRAPH_ARCHS = ["mamba2_370m", "mamba2_370m@bf16", "stablelm_3b",
               "recurrentgemma_2b", "dbrx_132b", "whisper_small"]


def start_wave(eng, cfg, params, b: int, depth: int, seed: int) -> None:
    """Prefill ``b`` rows into ``eng`` and set their first tokens. The
    encoder-decoder, which ``generate`` refuses, takes its cache, tokens
    and positions from ``model.prefill`` whole (B == slots)."""
    dev = eng.device
    gen = torch.Generator(dev).manual_seed(seed)
    if not cfg.is_encoder_decoder:
        eng.generate(torch.randint(0, cfg.vocab_size, (b, depth),
                                   generator=gen, device=dev), 1)
        return
    frames = torch.randn((b, depth, cfg.d_model), generator=gen,
                         device=dev).to(getattr(torch, cfg.dtype))
    tokens = torch.randint(0, cfg.vocab_size, (b, 4), generator=gen,
                           device=dev)
    logits, eng.cache = tm.prefill(params, cfg, {"frames": frames,
                                                 "tokens": tokens})
    eng.current.copy_(torch.argmax(logits, dim=-1))
    eng.pos.fill_(tokens.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_replayed_steps_equal_the_eager_step(cuda_device, arch):
    """Over a B < slots wave, a B == slots wave (the prefill cache
    adopted, then copied into the static one), after release a
    re-admitted B < slots wave, and last a B == slots wave of a prompt
    shorter than ``max_len`` (its rings are ``max_len`` deep all the
    same, so the graph stays), every replayed step's tokens and float32
    logits equal an eager step's from the same state, bit for bit. One
    capture per engine; every other step replays."""
    name, _, dtype = arch.partition("@")
    cfg = reduced(get_config(name))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype={"bf16": "bfloat16"}[dtype])
    params = tm.init_params(cfg, seed=0, device=cuda_device)
    slots, depth, steps = 4, 32, 16
    eng = ServingEngine(cfg, params, slots=slots, max_len=depth,
                        device=cuda_device)
    decode = make_decode_fn(cfg, "cuda")
    if cfg.is_encoder_decoder:
        waves = [(slots, depth), (slots, depth)]
    else:
        waves = [(2, depth), (slots, depth), (3, depth),
                 (slots, depth // 2)]
    captures = 1
    for k, (b, s) in enumerate(waves):
        start_wave(eng, cfg, params, b, s, seed=k)
        cache, cur, pos = tree_map(torch.clone, eng.cache), \
            eng.current.clone(), eng.pos.clone()
        for _ in range(steps):
            replays = eng.graph_replays
            tok = eng.step()
            logits, cache = decode(params, cur, cache, pos)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
            np.testing.assert_array_equal(tok, cur.cpu().numpy())
            assert torch.equal(eng.pos, pos)
            if eng.graph_replays > replays:
                assert torch.equal(eng._graph_logits, logits)
        for r in np.flatnonzero(eng.active):
            eng.release(int(r))
    assert eng.graph_captures == captures
    assert eng.graph_replays == len(waves) * steps - captures
