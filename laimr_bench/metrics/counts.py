"""Operation and byte counts of the served models and of their kernels,
from shapes alone: the arithmetic behind the benchmark's MFU and
roofline readings. 2 FLOP per multiply-add throughout.

Model FLOPs count the work the model needs for the tokens it serves:
every projection and MLP product, attention over the causal pairs, the
Mamba-2 recurrence as written (state update and readout, 5 FLOP per
state element and token), and the head for the positions that give a
token. Elementwise passes (norms, activations, rotary, conv) are left
out but for the depthwise conv's multiply-adds. Each kind of
layer counts its own (``families/<kind>.py``); the sum over a stack,
the head, the shape helpers and the kernels' counts are here.
"""
from __future__ import annotations

from laimr_bench import families

SSD_CHUNK = 64


def ssm_dims(dims: dict) -> dict:
    """The derived widths of a ``mamba2`` layer."""
    d_in = dims["ssm_expand"] * dims["d_model"]
    gn = dims["ssm_groups"] * dims["ssm_state"]
    return dict(d_in=d_in, heads=d_in // dims["ssm_head_dim"],
                conv=d_in + 2 * gn,
                proj=2 * d_in + 2 * gn + d_in // dims["ssm_head_dim"])


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def head_flops(dims: dict) -> int:
    """The head at one position."""
    return 2 * dims["d_model"] * dims["vocab_size"]


def prefill_flops(family: str, dims: dict, b: int, s: int) -> int:
    """A prefill of b prompts of s tokens through a stack of ``family``
    (``dims`` under the port's field names): each layer by its kind
    (``families/<kind>.py``), the head at the last position."""
    return sum(families.get(k).layer_prefill_flops(dims, b, s)
               for k in families.kinds(family, dims)) \
        + b * head_flops(dims)


def decode_flops(family: str, dims: dict, rows: int, pos: int) -> int:
    """One decode step of ``rows`` live sequences, each token at position
    ``pos`` (attending to pos + 1 keys), through a stack of ``family``,
    the head at every row."""
    return rows * (sum(families.get(k).layer_decode_flops(dims, pos)
                       for k in families.kinds(family, dims))
                   + head_flops(dims))


def flash_bytes_ops(b, s, h, d, elem=2, hkv=None) -> tuple[int, int]:
    """Causal self-attention at prefill: q and out, k and v read or
    written once; QK^T and PV over the s(s+1)/2 visible pairs."""
    hkv = h if hkv is None else hkv
    return (2 * b * s * h * d + 2 * b * s * hkv * d) * elem, \
        4 * b * h * d * causal_pairs(s)


def ssd_bytes_ops(b, l, h, p, g, n, elem=2) -> tuple[int, int]:
    """x read and y written (``elem`` bytes each), dt (float32), b and c
    (``elem``), a and d_skip read once, the float32 final state written;
    the chunked algorithm's FLOPs per (row, head, chunk of Q = 64): C B^T
    (Q Q N), C H^T (Q P N), the masked product with x (Q Q P) and the
    state update (Q P N)."""
    q = SSD_CHUNK
    chunks = b * h * (-(-l // q))
    nbytes = 2 * b * l * h * p * elem + b * l * h * 4 \
        + 2 * b * l * g * n * elem + 2 * h * 4 + b * h * p * n * 4
    return nbytes, chunks * 2 * (q * q * n + 2 * q * p * n + q * q * p)


def bound_s(nbytes: int, ops: int, peak_flops: float, peak_bytes: float
            ) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(nbytes / peak_bytes, ops / peak_flops)
