"""The FLOP and byte counts behind the MFU and roofline readings, held
to shape arithmetic at one small shape: PyTorch's own FLOP counter over
the plain reference, and bytes counted tensor by tensor."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from laimr_bench import replica
from laimr_bench.metrics import counts
from laimr_bench.reference import model_ref
from laimr_bench.tests import tiny


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_attn_prefill_and_decode_flops():
    conf = tiny.conf("stablelm_3b")
    k = replica.dims(conf)
    params = replica.make_params("attn", replica.arch_config(conf), 1,
                                 "cpu")
    b, s = 2, 12
    tokens = torch.zeros((b, s), dtype=torch.int64)
    got = counted(lambda: model_ref.logits(conf, params, tokens, s - 1))
    # the reference scores every (query, key) pair; the count, the causal
    # ones
    attn = 4 * b * k["n_heads"] * k["head_dim"]
    full = k["n_layers"] * attn * (s * s - counts.causal_pairs(s))
    assert counts.prefill_flops("attn", k, b, s) + full == got
    # a step at position s - 1 is the prefill's last row (every key before
    # it and its own) with the head
    one = counts.prefill_flops("attn", k, 1, s) \
        - counts.prefill_flops("attn", k, 1, s - 1)
    head = 2 * k["d_model"] * k["vocab_size"]
    assert counts.decode_flops("attn", k, 3, s - 1) == 3 * (one + head)


def test_mamba2_projection_and_head_flops():
    k = replica.dims(tiny.conf("mamba2_370m"))
    m = counts.ssm_dims(k)
    d, v = k["d_model"], k["vocab_size"]
    b, s = 2, 5
    x = torch.zeros(b, s, d)
    got = counted(lambda: (x @ torch.zeros(d, m["proj"]),
                           torch.zeros(b, s, m["d_in"])
                           @ torch.zeros(m["d_in"], d)))
    conv = 2 * k["conv_width"] * m["conv"] * b * s
    scan = 5 * m["heads"] * k["ssm_head_dim"] * k["ssm_state"] * b * s
    head = counted(lambda: torch.zeros(b, d) @ torch.zeros(d, v))
    assert counts.prefill_flops("mamba2", k, b, s) == \
        k["n_layers"] * (got + conv + scan) + head
    assert counts.decode_flops("mamba2", k, 3, 40) == \
        3 * counts.prefill_flops("mamba2", k, 1, 1)


def test_an_unknown_layer_kind_has_no_count():
    k = replica.dims(tiny.conf("mamba2_370m"))
    with pytest.raises(ValueError):
        counts.prefill_flops("rglru", k, 1, 1)


def test_flash_bytes_ops():
    b, s, h, hkv, d = 2, 16, 4, 2, 8
    nbytes, ops = counts.flash_bytes_ops(b, s, h, d, hkv=hkv)
    q = torch.zeros(b, h, s, d)
    kk = torch.zeros(b, h, s, d)
    full = counted(lambda: (q @ kk.transpose(-1, -2)) @ kk)
    assert ops * s * s == full * counts.causal_pairs(s)
    assert nbytes == 2 * (2 * b * s * h * d + 2 * b * s * hkv * d)


def test_ssd_bytes_ops():
    b, l, h, p, g, n = 2, 100, 3, 8, 1, 4
    nbytes, ops = counts.ssd_bytes_ops(b, l, h, p, g, n)
    want = (2 * b * l * h * p * 2 + b * l * h * 4 + 2 * b * l * g * n * 2
            + 2 * h * 4 + b * h * p * n * 4)
    assert nbytes == want
    q, chunks = 64, b * h * 2
    assert ops == chunks * 2 * (q * q * n + 2 * q * p * n + q * q * p)


def test_bound_is_the_slower_of_the_two():
    assert counts.bound_s(10, 1, 1.0, 1.0) == 10
    assert counts.bound_s(1, 10, 1.0, 1.0) == 10
