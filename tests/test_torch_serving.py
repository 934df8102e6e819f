"""The port's ``ServingEngine`` against the JAX package's, on the CPU.

Both engines run the reduced StableLM-3B config in float32 with the
reference's weights from ``jax.random.PRNGKey(0)`` (carried across by
``model_params_from_numpy``) on prompts drawn with numpy from stated
seeds; the port runs ``device="cpu", kernels="ref"`` (the plain versions
of its attention kernels). Greedy tokens must be equal. Both engine
paths are driven: ``b == slots`` adopts the prefill cache as an S-deep
ring, ``b < slots`` merges it into the ``max_len``-deep cache.

The reference's own engine tests (``tests/test_serving.py``) are ported
as well: manual decode, slot management, positions, the partial-batch
merge and idle-slot invariance.

The reduced Mamba2-370m is served the same way (``TestMamba2Engine``):
both paths carry its conv buffers and SSM states instead of KV rings, at
a prompt length no chunk of 64 divides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.models import model as jm
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as tm
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import (GenerationResult, _merge_batch,
                                        make_decode_fn, make_prefill_fn)

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
        (4, 16, 4, 4, 64),      # b == slots: the S-deep prefill ring
        (2, 8, 3, 4, 64),       # b < slots: merged into max_len
        (3, 24, 6, 3, 16),      # b == slots, decode wraps the 24-deep ring
    ])
    def test_greedy_tokens_match(self, setup, b, s, steps, slots, max_len):
        jc, jp, tc, tp = setup
        p = prompts(b * 100 + s, b, s, tc.vocab_size)
        want = JaxEngine(jc, jp, slots=slots, max_len=max_len) \
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
        prefill, decode = make_prefill_fn(cfg, "ref"), make_decode_fn(
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
