"""Per-device cost accounting of eager ops: the twin of the reference's
``repro.launch.hlo_analysis``.

The reference parses optimized HLO text; the port has no compiled
program, so a ``TorchDispatchMode`` (:class:`OpCounter`) counts the ops
a step runs, with the reference's ``Costs`` and counting rules:

* ``flops``       — 2 x M x N x K for every product (``mm``, ``addmm``,
                    ``bmm``, ``baddbmm``, and ``mv`` / ``dot``): what an
                    einsum or a matmul lowers to;
* ``bytes``       — an HBM-traffic proxy: 2 x output bytes (write + one
                    read) for every op that materialises a tensor, plus
                    the operand bytes of each product; an in-place
                    scatter or index write counts 2 x the bytes it
                    writes (the reference's dynamic-update-slice rule).
                    Views, ``detach``, ``empty`` and the collectives'
                    ``wait_tensor`` count nothing (``_FREE_OPS``);
* ``collectives`` — operand bytes by kind (``all-gather``,
                    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
                    ``collective-permute``), from the
                    ``_c10d_functional`` ops that DTensor issues.

Counts are **per device**: under DTensor the mode sees each DTensor op
first and declines it (``NotImplemented``), so DTensor runs it and the
mode then sees the local ops on this rank's shards, collectives
included. The ops DTensor's sharding propagation runs on fake tensors
(global shapes, to infer output metadata) are passed through uncounted.
Eager torch has no ``while``: a Python loop over layers runs, and is
counted, layer by layer, so no trip-count rule is needed.

``torch_flops`` is ``torch.utils.flop_counter``'s own count
(``FlopCounterMode``'s formula registry) over the same local ops, the
counterpart of the reference's ``xla_flops``. ``temp_peak`` is the peak
of live bytes that ops materialised during the run (each output counted
until it is freed; arguments not included), the counterpart of XLA's
``temp_size_in_bytes``.

Every number is accounting over shapes (meta tensors in the dry run),
not a measurement.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: functional collective op name -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
#: ops that materialise nothing
_FREE_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "wait_tensor", "_wrap_tensor_autograd", "_local_scalar_dense",
             "set_", "resize_", "_unsafe_view", "view", "_reshape_alias",
             "as_strided", "sym_size", "sym_stride", "sym_numel",
             "is_same_size", "_to_copy_view"}
#: products (``_product_flops``)
_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot")
#: in-place writes of part of a tensor: 2 x the bytes written
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
             "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_",
             "masked_scatter_", "masked_fill_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    return 2.0 * args[0].numel()               # mv, dot


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    torch_flops: float = 0.0
    temp_peak: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


def _kinds():
    """Tensor subclasses the counter declines or passes through."""
    declined, passed = (), ()
    try:
        from torch.distributed.tensor import DTensor
        declined = (DTensor,)
    except ImportError:       # a torch without distributed
        pass
    from torch._subclasses.fake_tensor import FakeTensor
    passed = (FakeTensor,)
    return declined, passed


class OpCounter(TorchDispatchMode):
    """Counts the local ops run under it into ``self.costs``."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._declined, self._passed = _kinds()
        self._live = 0
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry

    def _freed(self, n: int) -> None:
        self._live -= n

    def _hold(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if n == 0:
            return
        self._live += n
        self.costs.temp_peak = max(self.costs.temp_peak, self._live)
        weakref.finalize(t, self._freed, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._declined) for t in types):
            return NotImplemented      # DTensor runs it; we see its locals
        out = func(*args, **kwargs)
        if any(issubclass(t, self._passed) for t in types):
            return out                 # sharding propagation's fake run
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        c = self.costs
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                op_bytes = sum(_nbytes(a) for a in tree_leaves(args)) or \
                    sum(_nbytes(o) for o in tree_leaves(out))
                c.collectives[kind] = c.collectives.get(kind, 0.0) + op_bytes
                c.bytes += sum(_nbytes(o) for o in tree_leaves(out))
            return
        if packet in self._registry:
            c.torch_flops += float(self._registry[packet](
                *args, **kwargs, out_val=out))
        if name in _FREE_OPS:
            return
        returns = func._schema.returns
        aliased = [r.alias_info for r in returns if r.alias_info is not None]
        if aliased and not any(a.is_write for a in aliased):
            return                     # a view
        if name in _PRODUCTS:
            c.flops += _product_flops(name, args, out)
            c.bytes += _nbytes(out) + sum(
                _nbytes(a) for a in args if isinstance(a, torch.Tensor))
            self._hold(out)
            return
        if aliased:                    # in place (or out=)
            if name in _SCATTERS:
                src = [a for a in tree_leaves((args[1:], kwargs))
                       if isinstance(a, torch.Tensor)
                       and a.dtype.is_floating_point == args[0].dtype
                       .is_floating_point and a.dtype != torch.bool]
                written = _nbytes(src[-1]) if src else 0
                if name.startswith(("scatter", "index_fill", "masked_fill")):
                    idx = [a for a in tree_leaves(args[1:])
                           if isinstance(a, torch.Tensor)]
                    written = max(written, idx[0].numel()
                                  * args[0].element_size()) if idx \
                        else written
                c.bytes += 2.0 * written
            else:
                c.bytes += 2.0 * sum(_nbytes(o) for o in tree_leaves(out))
            return
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor):
                c.bytes += 2.0 * _nbytes(o)
                self._hold(o)


def analyze(fn, *args, **kwargs):
    """(fn(*args, **kwargs), Costs) with the run counted."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.costs
