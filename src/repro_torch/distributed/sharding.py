"""Sharding rules of the port: tensor path -> spec -> DTensor placements.

The twin of the reference's ``repro.distributed.sharding``. A *spec* is
a plain tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or None (PartitionSpec's meaning, no JAX type). ``placements``
turns it into DTensor placements on a ``DeviceMesh``, and the
``distribute_*`` functions apply those to trees of tensors (meta tensors
in the dry run, ``repro_torch.launch``).

Mesh axes
---------
  single pod :  (data=16, model=16)
  multi-pod  :  (pod=2, data=16, model=16)  — "pod" composes with "data"
                into the batch/FSDP axis tuple ("pod", "data").

Strategy (the reference's, rule for rule)
-----------------------------------------
* **Training** (train_4k): FSDP over the batch axes x tensor parallel
  over "model". Every weight matrix shards its TP-natural dim over
  "model" (attention heads / FFN hidden / experts / vocab) and its
  d_model dim over the batch axes. Optimizer state follows params.
* **Serving** (prefill/decode): TP over "model"; params replicated over
  "data" unless ``cfg.serve_fsdp`` keeps the FSDP axis.
* **Divisibility guard**: a dim is sharded only when its size divides
  the axis size; otherwise the next-preference dim is tried.
* **Decode caches**: KV heads over "model" when divisible, else the
  cache-length dim; batch over the batch axes, except long_500k
  (batch=1) which context-shards the cache length over "data".

Paths are the port's own: ``layers/{i}/attn/wq``, ``enc_layers/{i}/...``,
``dec_layers/{i}/...``. The port unrolls the reference's stacked
``blocks/layer{j}`` periods into one dict per layer, so no leaf has the
reference's leading period axis and no spec has its leading None.

``mesh`` in the rules is a ``DeviceMesh`` or a mapping from axis name to
size (``{"data": 16, "model": 16}``), so the rules are pure functions of
shapes, usable without a process group.

Hooks
-----
``constrain_batch`` and the MoE hooks are the reference's
``with_sharding_constraint`` points. On a DTensor each is a
``redistribute`` to the reference's spec; on a plain tensor, or while
the hooks are unset (the default), each returns its argument itself, so
serving and training on one card never see them.

The other helpers are the repairs for what DTensor has no rule for (or,
in torch 2.11, a stricter one): each runs the plain computation on every
device's own shards, and on plain tensors is the plain call itself.
``local_groups`` (the MoE's sort / rank / scatter dispatch and combine),
``ring_fill`` / ``ring_write`` (the ring caches), ``take_last`` (the
vocab-parallel gold logit), ``embed_lookup`` (the vocab-parallel
embedding and its backward), ``local_attention`` /
``local_decode_attention`` (attention by batch and heads, a
sequence-sharded cache read where it lies), ``local_scan`` /
``local_state_step`` (the SSD recurrence), and ``reduce_partial`` /
``unflattenable`` / ``pin`` around the head projections.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch

PyTree = Any
Spec = tuple

# ----------------------------------------------------------------- hooks
_ACT_BATCH_AXES = None
_MOE_EXPERT_AXIS = None
_MOE_GROUPS = 1          # token groups for data-local dispatch


def set_activation_batch_axes(axes) -> None:
    """axes: e.g. ("data",) or ("pod", "data"), or None to disable."""
    global _ACT_BATCH_AXES
    _ACT_BATCH_AXES = None if axes is None else tuple(axes)


def set_moe_expert_axis(axis, groups: int = 1) -> None:
    global _MOE_EXPERT_AXIS, _MOE_GROUPS
    _MOE_EXPERT_AXIS = axis
    _MOE_GROUPS = max(1, groups)


def moe_num_groups() -> int:
    return _MOE_GROUPS


def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _as_dtensor(t, mesh):
    """``t``, or a plain tensor as a DTensor replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return t if _is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim)


def _local(t, mesh, place):
    """This rank's shard of ``t`` (a plain tensor counts as replicated)
    under ``place``."""
    return _as_dtensor(t, mesh).redistribute(mesh, list(place)).to_local()


def _wrap(t, mesh, place):
    """A local result ``t`` as a DTensor with ``place``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, list(place), run_check=False)


def _offset(x, dim: int, place) -> tuple[int, int]:
    """(first global index, local length) of this rank's slice of ``x``'s
    ``dim`` under ``place``."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    offset, length = 0, x.shape[dim]
    for i, p in enumerate(place):
        if p.is_shard() and p.dim == dim:
            length //= mesh.size(i)
            offset = offset * mesh.size(i) + coord[i] * length
    return offset, length


def _constrain(x, spec: Spec):
    """``x`` redistributed to ``spec`` when it is a DTensor, else ``x``."""
    if not _is_dtensor(x):
        return x
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_batch(x):
    """Constrain dim 0 of an activation to the configured batch axes."""
    if _ACT_BATCH_AXES is None:
        return x
    return _constrain(x, (_ACT_BATCH_AXES,) + (None,) * (x.ndim - 1))


def _group_axes():
    return _ACT_BATCH_AXES if _ACT_BATCH_AXES else None


def constrain_moe_groups(x):
    """x: (G, ...) grouped tokens -> groups over the batch axes."""
    if _MOE_EXPERT_AXIS is None:
        return x
    return _constrain(x, (_group_axes(),) + (None,) * (x.ndim - 1))


def constrain_moe_buffer(buf):
    """buf: (G, E, C, d) dispatch buffer -> groups over the batch axes,
    experts over the model axis."""
    if _MOE_EXPERT_AXIS is None:
        return buf
    return _constrain(buf, (_group_axes(), _MOE_EXPERT_AXIS, None, None))


def constrain_moe_weight(w):
    """Expert weight (E, d, ff)/(E, ff, d) at compute time:
    expert-parallel only (all-gather the FSDP shards rather than
    all-reduce activations)."""
    if _MOE_EXPERT_AXIS is None:
        return w
    return _constrain(w, (_MOE_EXPERT_AXIS, None, None))


def local_groups(fn, *args):
    """``fn(*args)`` on each device's own token groups.

    Plain tensors: ``fn(*args)``. DTensors: every tensor argument is
    redistributed so that dim 0 (the token groups) is sharded over the
    batch axes while the MoE hooks are set (each device then holds its
    own groups, the reference's data-local dispatch), or replicated
    everywhere when they are not (one group of all tokens, computed on
    every device, as GSPMD lowers the reference's unconstrained sort);
    ``fn`` runs on the local tensors and its tensor outputs come back as
    DTensors with those placements."""
    dts = [a for a in args if _is_dtensor(a)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    grp = _group_axes() if _MOE_EXPERT_AXIS is not None else None

    def place(t):
        return placements((grp,) + (None,) * (t.ndim - 1), mesh)
    out = fn(*(_local(a, mesh, place(a)) if isinstance(a, torch.Tensor)
               else a for a in args))
    outs = out if isinstance(out, tuple) else (out,)
    outs = tuple(_wrap(o, mesh, place(o)) if isinstance(o, torch.Tensor)
                 else o for o in outs)
    return outs if isinstance(out, tuple) else outs[0]


def ring_write(cache: torch.Tensor, slot: torch.Tensor,
               value: torch.Tensor) -> None:
    """``cache[b, slot[b]] = value[b]`` for every row b, in place.

    Plain tensors: one ``index_put_``. A DTensor cache is written on
    each device's own shard: the batch and head dims of ``value`` are
    redistributed to the cache's, and a cache whose length is sharded
    writes only the slots its shard holds (a masked write of the same
    rows, so every shape stays static)."""
    if not _is_dtensor(cache):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    # value (B, ...) follows the cache's placements on every dim but 1
    vplace = [Shard(p.dim if p.dim == 0 else p.dim - 1)
              if isinstance(p, Shard) and p.dim != 1 else Replicate()
              for p in cache.placements]
    bplace = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in vplace]
    value = _local(value, mesh, vplace)
    local = cache.to_local()
    offset, length = _offset(cache, 1, cache.placements)
    local_slot = _local(slot, mesh, bplace).long() - offset
    inside = (local_slot >= 0) & (local_slot < length)
    local_slot = local_slot.clamp(0, length - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    if length != cache.shape[1]:
        keep = inside.view((-1,) + (1,) * (value.ndim - 1))
        value = torch.where(keep, value, local[bidx, local_slot])
    local[bidx, local_slot] = value


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself in the forward; for a DTensor, its gradient is
    redistributed to ``x``'s placements in the backward. Put after a
    flatten of head dims, it keeps the backward's un-flatten of the
    gradient from meeting a flat dim sharded over more devices than the
    heads divide (a backward has no hook point of its own)."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor holding partial sums (a row-parallel projection's
    output) all-reduced to replicated on those mesh dims; anything else
    returned itself. The attention's q, k and v pass through it: their
    products with partial operands are not a sum of the partial
    products."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def local_attention(attend, q, k, v, pos, *, mask_free: bool = False,
                    softcap: float = 0.0, scale=None):
    """``attend(q, k, v, pos)`` (attention of q (B, Sq, H, D) over k, v
    (B, Skv, Hkv, D), query positions (B, Sq)) on each device's own
    sequences and heads.

    Plain tensors: the call itself. DTensors: each mesh dim that shards
    q's batch keeps it for every argument; one that shards q's heads
    keeps them, and k's and v's too when their heads divide, else k and v
    are gathered and each device takes the kv heads its q heads read
    (GQA: q head h reads kv head h // (H / Hkv)); anything else
    (sequence, partial sums) is gathered. The attention then runs on
    local tensors, with no DTensor rule needed inside it. ``mask_free``
    attention (no causal mask, no window: cross-attention) over keys
    whose sequence is sharded reads them where they lie instead: local
    scores, then the softmax's max, sum and weighted values all-reduced
    (:func:`_split_softmax`, with the plain version's ``softcap`` and
    ``scale``)."""
    if not _is_dtensor(q):
        return attend(q, k, v, pos)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    rep = Replicate()
    h, hkv = q.shape[2], k.shape[2]
    heads = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if isinstance(p, Shard) and p.dim == 2)
    qp, kp, pp, split = [], [], [], []
    for i, (p, pk) in enumerate(zip(q.placements, _as_dtensor(
            k, mesh).placements)):
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p), kp.append(p), pp.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            qp.append(p), pp.append(rep)
            kp.append(p if hkv % heads == 0 else rep)
        elif mask_free and isinstance(pk, Shard) and pk.dim == 1:
            qp.append(rep), kp.append(pk), pp.append(rep)
            split.append((mesh, i))
        else:
            qp.append(rep), kp.append(rep), pp.append(rep)
    ql, kl, vl = _local(q, mesh, qp), _local(k, mesh, kp), _local(v, mesh, kp)
    if kl.shape[2] == hkv and ql.shape[2] < h:
        h0, hl = _offset(q, 2, qp)
        group = h // hkv
        lo, hi = h0 // group, (h0 + hl - 1) // group + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    if split:
        out = _split_softmax(ql, kl, vl, None, split, softcap, scale)
    else:
        out = attend(ql, kl, vl, _local(pos, mesh, pp))
    return _wrap(out, mesh, qp)


def local_decode_attention(attend, q, k_cache, v_cache, kv_pos, q_pos, *,
                           window=0, softcap=0.0, scale=None):
    """``attend(q, k_cache, v_cache, kv_pos, q_pos)`` (one query (B, H, D)
    per row against a (B, C, Hkv, D) ring) on each device's own rows,
    heads and cache slots.

    Plain tensors: the call itself. DTensors: the cache's batch and
    kv-head sharding is kept (q follows it); a cache whose length is
    sharded is read where it lies, flash-decoding style: each device
    scores its own slots, and the softmax's max, sum and weighted values
    are all-reduced over the mesh dims that shard the length, so no
    cache slot moves. ``window``, ``softcap`` and ``scale`` are the plain
    version's (``kernels/ref.decode_attention_ref``)."""
    if not _is_dtensor(k_cache):
        return attend(q, k_cache, v_cache, kv_pos, q_pos)
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    rep = Replicate()
    qp, cp, pp, sp, split = [], [], [], [], []
    for i, p in enumerate(k_cache.placements):
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p), cp.append(p), pp.append(p), sp.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            qp.append(Shard(1)), cp.append(p), pp.append(rep)
            sp.append(rep)
        elif isinstance(p, Shard) and p.dim == 1:
            qp.append(rep), cp.append(p), pp.append(p), sp.append(rep)
            split.append(i)
        else:
            qp.append(rep), cp.append(rep), pp.append(rep), sp.append(rep)
    ql, kl, vl = (_local(q, mesh, qp), _local(k_cache, mesh, cp),
                  _local(v_cache, mesh, cp))
    posl, qpl = _local(kv_pos, mesh, pp), _local(q_pos, mesh, sp)
    if not split:
        out = attend(ql, kl, vl, posl, qpl)
    else:
        valid = (posl >= 0) & (posl <= qpl[:, None])
        if window > 0:
            valid &= posl > (qpl[:, None] - window)
        out = _split_softmax(ql, kl, vl, valid, [(mesh, i) for i in split],
                             softcap, scale)
    return _wrap(out, mesh, qp)


def _split_softmax(q, k, v, valid, groups, softcap, scale):
    """The plain attention of q (B, [Sq,] H, D) over k, v (B, C, Hkv, D)
    whose slots are split across ``groups`` (mesh, dim): local scores
    (masked by ``valid`` (B, C) when given), then the max, the exp-sum
    and the weighted values all-reduced. A row with no valid slot
    anywhere averages every slot's V, as the plain version does."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.kernels.ref import NEG_INF, _repeat_kv, _softcap
    one = q.ndim == 3
    if one:
        q = q[:, None]
    b, sq, h, d = q.shape
    kf = _repeat_kv(k, h // k.shape[2]).to(torch.float32)
    vf = _repeat_kv(v, h // v.shape[2]).to(torch.float32)
    scale = d ** -0.5 if scale is None else scale
    logits = _softcap(torch.einsum("bqhd,bchd->bhqc", q.to(torch.float32),
                                   kf) * scale, softcap)
    if valid is not None:
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqc,bchd->bhqd", p, vf)
    for g in groups:
        s = funcol.all_reduce(s, "sum", g)
        o = funcol.all_reduce(o, "sum", g)
    out = (o / s).transpose(1, 2).to(q.dtype)              # (B, Sq, H, D)
    return out[:, 0] if one else out


def local_state_step(step, h, dt, a, x, b, c, d_skip):
    """``step(h, dt, a, x, b, c, d_skip)``: one decode token's SSM
    recurrence, h (B, H, P, N) updated in place, dt (B, H), a and d_skip
    (H,), x (B, H, P), b and c (B, H, N); returns y (B, H, P).

    Plain tensors: the call itself. A DTensor state is stepped on each
    device's own rows and heads: the arguments follow its batch and head
    sharding (a and d_skip by head), and the update lands in its local
    shard."""
    if not _is_dtensor(h):
        return step(h, dt, a, x, b, c, d_skip)
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    rep = Replicate()
    rows, heads = [], []
    for p in h.placements:
        if isinstance(p, Shard) and p.dim == 0:
            rows.append(p), heads.append(rep)
        elif isinstance(p, Shard) and p.dim == 1:
            rows.append(p), heads.append(Shard(0))
        else:
            rows.append(rep), heads.append(rep)
    y = step(h.to_local(), _local(dt, mesh, rows), _local(a, mesh, heads),
             _local(x, mesh, rows), _local(b, mesh, rows),
             _local(c, mesh, rows), _local(d_skip, mesh, heads))
    return _wrap(y, mesh, rows)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: embedding rows (..., d) of integer ``ids``.

    Plain tensors: one index. A DTensor table is read where it lies,
    vocab-parallel: its d_model is gathered (the FSDP all-gather), each
    device looks up the ids its vocab shard holds (zeros elsewhere), and
    the result is a partial sum over the vocab-sharding mesh dims, with
    the ids' batch sharding kept."""
    if not _is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    rep = Replicate()
    tp, ip, op = [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        if isinstance(pt, Shard) and pt.dim == 0:
            tp.append(pt), ip.append(rep), op.append(Partial())
        elif isinstance(pi, Shard):
            tp.append(rep), ip.append(pi), op.append(pi)
        else:
            tp.append(rep), ip.append(rep), op.append(rep)
    local_t = _local(table, mesh, tp)
    v0, vl = _offset(table, 0, tp)
    local_i = _local(ids, mesh, ip).long() - v0
    inside = (local_i >= 0) & (local_i < vl)
    rows = local_t[local_i.clamp(0, vl - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _wrap(rows, mesh, op)


def local_scan(scan, x, dt, a, b, c, d_skip, initial_state=None,
               return_final_state=False):
    """``scan(x, dt, a, b, c, d_skip, initial_state, return_final_state)``
    (an SSD scan: x (B, L, H, P), dt (B, L, H), a and d_skip (H,), b and
    c (B, L, G, N), the state (B, H, P, N)) on each device's own rows.

    Plain tensors: the call itself. DTensors: the recurrence is
    independent per sequence and per head, so every mesh dim that shards
    x's batch (dim 0) or heads (dim 2) keeps that sharding for the scan
    (b and c replicated over a head-sharding dim), the rest is gathered,
    and the scan runs on local tensors: one op per step on each shard
    rather than one DTensor dispatch per step."""
    if not _is_dtensor(x):
        return scan(x, dt, a, b, c, d_skip, initial_state,
                    return_final_state)
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    rep = Replicate()
    # per mesh dim: placements of x, dt, a, b and c, d_skip, state, y
    cols = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim == 0:
            cols.append((p, p, rep, p, rep, Shard(0), p))
        elif isinstance(p, Shard) and p.dim == 2:
            cols.append((p, Shard(2), Shard(0), rep, Shard(0), Shard(1), p))
        else:
            cols.append((rep,) * 7)
    pl = [list(col) for col in zip(*cols)]
    out = scan(_local(x, mesh, pl[0]), _local(dt, mesh, pl[1]),
               _local(a, mesh, pl[2]), _local(b, mesh, pl[3]),
               _local(c, mesh, pl[3]), _local(d_skip, mesh, pl[4]),
               None if initial_state is None
               else _local(initial_state, mesh, pl[5]), return_final_state)
    if return_final_state:
        y, h = out
        return _wrap(y, mesh, pl[6]), _wrap(h, mesh, pl[5])
    return _wrap(out, mesh, pl[6])

def unflattenable(x: torch.Tensor, sizes: tuple) -> torch.Tensor:
    """``x`` ready for ``x.unflatten(-1, sizes)``: a DTensor whose last
    dim is sharded over more devices than ``sizes[0]`` divides (8 kv
    heads of a head-flattened projection over a 16-way axis) is gathered
    along those mesh dims first; anything else is returned itself."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    lead, place, changed = sizes[0], [], False
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            n = x.device_mesh.size(i)
            if lead % n:
                place.append(Replicate())
                changed = True
                continue
            lead //= n
        place.append(p)
    return x.redistribute(x.device_mesh, place) if changed else x


def ring_fill(fill, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
    """``fill(k, v, pos)`` -> (k_cache, v_cache, kv_pos), the prefill's
    ring caches from its newest keys, values (B, n, Hkv, hd) and their
    positions (B, n).

    Plain tensors: ``fill(k, v, pos)``. DTensors: the fill runs on each
    device's own rows: the batch dim and the kv-head dim keep ``k``'s
    sharding, the token dim is gathered, and the caches come back with
    those placements."""
    if not _is_dtensor(k):
        return fill(k, v, pos)
    from torch.distributed.tensor import Replicate, Shard
    mesh = k.device_mesh
    kv = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in k.placements]
    rows = [p if p.is_shard() and p.dim == 0 else Replicate() for p in kv]
    k_c, v_c, p_c = fill(_local(k, mesh, kv), _local(v, mesh, kv),
                         _local(pos, mesh, rows))
    return (_wrap(k_c, mesh, kv), _wrap(v_c, mesh, kv),
            _wrap(p_c, mesh, rows))


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``gather(x, -1, index[..., None])[..., 0]``: each row's entry at
    ``index`` (cross-entropy's gold logit).

    Plain tensors: one ``gather``. A DTensor ``x`` whose last dim is
    sharded (vocab-parallel logits) gathers on each device's own
    columns, zero where the index lies in another shard, and returns a
    partial sum over those mesh dims (one all-reduce of the rows when it
    is read)."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, index.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    xp, ip, outp = [], [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim == last:
            xp.append(p), ip.append(Replicate()), outp.append(Partial())
        elif isinstance(p, Shard):
            xp.append(p), ip.append(p), outp.append(p)
        else:
            xp.append(Replicate()), ip.append(Replicate())
            outp.append(Replicate())
    offset, width = _offset(x, last, xp)
    local_x = _local(x, mesh, xp)
    local_i = _local(index, mesh, ip).long() - offset
    inside = (local_i >= 0) & (local_i < width)
    gold = torch.gather(local_x, -1, local_i.clamp(0, width - 1)[..., None])
    gold = torch.where(inside, gold[..., 0], torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    return _wrap(gold, mesh, outp)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh):
    """The compound batch/FSDP axis tuple for this mesh."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axsize(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _fits(dim: int, mesh, axis) -> bool:
    n = _axsize(mesh, axis)
    return dim % n == 0 and dim >= n


def param_spec(path: str, shape: tuple, mesh, *, fsdp: bool) -> Spec:
    """Spec for one parameter leaf; ``path`` is the '/'-joined key path
    of the port's param tree."""
    ba = batch_axes(mesh)
    fs = ba if fsdp else None          # the FSDP slot (None = replicate)
    core = tuple(shape)
    nd = len(core)

    def fsdp_ax(dim):
        return fs if (fsdp and fs and _fits(dim, mesh, ba)) else None

    def tp_ax(dim):
        return "model" if _fits(dim, mesh, "model") else None

    name = path.split("/")[-1]

    # ---------------- embeddings / head ----------------
    if name == "embed" and nd == 2:                     # (V, d)
        v, d = core
        return (tp_ax(v), fsdp_ax(d))
    if name == "lm_head" and nd == 2:                   # (d, V)
        d, v = core
        return (fsdp_ax(d), tp_ax(v))

    # ---------------- attention ----------------
    if name in ("wq", "wk", "wv") and nd == 3:          # (d, H, hd)
        d, h, hd = core
        if _fits(h, mesh, "model"):
            return (fsdp_ax(d), "model", None)
        # heads not divisible: row-parallel on d_model
        return (tp_ax(d) or fsdp_ax(d), None, None) if not fsdp \
            else (fsdp_ax(d), None, None)
    # (H, hd, d) attention out; an expert "wo" (E, ff, d) takes this
    # branch too, as in the reference, where it gives the MoE rule
    if name == "wo" and nd == 3:
        h, hd, d = core
        if _fits(h, mesh, "model"):
            return ("model", None, fsdp_ax(d))
        return (None, None, tp_ax(d) if not fsdp else fsdp_ax(d))

    # ---------------- MoE ----------------
    if nd == 3 and name in ("wi", "wg"):                # (E, d, ff)
        e, d, ff = core
        return (tp_ax(e), fsdp_ax(d), None)
    if name == "router" and nd == 2:                    # (d, E)
        d, e = core
        return (fsdp_ax(d), None)

    # ---------------- dense MLP ----------------
    if name in ("wi", "wg") and nd == 2:                # (d, ff)
        d, ff = core
        return (fsdp_ax(d), tp_ax(ff))
    if name == "wo" and nd == 2:                        # (ff, d)
        ff, d = core
        return (tp_ax(ff), fsdp_ax(d))

    # ---------------- SSM / RG-LRU projections ----------------
    if name == "in_proj" and nd == 2:                   # (d, big)
        d, big = core
        return (fsdp_ax(d), tp_ax(big))
    if name == "out_proj" and nd == 2:                  # (big, d)
        big, d = core
        return (tp_ax(big), fsdp_ax(d))
    if name == "conv_w" and nd == 2:                    # (w, C)
        w, c = core
        return (None, tp_ax(c))

    # small vectors / norms / gates: replicate
    return (None,) * nd


def _batch_first(b: int, mesh):
    ba = batch_axes(mesh)
    return ba if _fits(b, mesh, ba) else \
        ("data" if _fits(b, mesh, "data") else None)


def batch_spec(shape: tuple, mesh) -> Spec:
    """Training/prefill batch leaves and decode-step per-sequence
    vectors: dim 0 over the batch axes (or "data" alone, or nothing)."""
    return (_batch_first(shape[0], mesh),) + (None,) * (len(shape) - 1)


def cache_spec(path: str, shape: tuple, mesh, cfg=None, *,
               long_context: bool) -> Spec:
    """Decode-cache spec of one leaf (``layers/{i}/k`` ...; the
    encoder-decoder's self ring is ``k``/``v``/``pos`` beside
    ``cross_k``/``cross_v``). See the module docstring."""
    name = path.split("/")[-1]
    core = tuple(shape)
    if name in ("k", "v", "cross_k", "cross_v"):
        b, c, hkv, hd = core
        if long_context:
            # batch=1: context-shard the cache length over "data"
            seq_ax = "data" if _fits(c, mesh, "data") else None
            head_ax = "model" if _fits(hkv, mesh, "model") else None
            return (None, seq_ax, head_ax, None)
        b_ax = _batch_first(b, mesh)
        if _fits(hkv, mesh, "model"):
            return (b_ax, None, "model", None)
        if _fits(c, mesh, "model"):
            return (b_ax, "model", None, None)
        return (b_ax, None, None, None)
    if name == "pos":
        b, c = core
        if long_context:
            return (None, "data" if _fits(c, mesh, "data") else None)
        return (_batch_first(b, mesh), None)
    if name == "ssm":                                   # (B, H, P, N)
        b, h, pdim, n = core
        return (_batch_first(b, mesh),
                "model" if _fits(h, mesh, "model") else None, None, None)
    if name == "conv":                                  # (B, W-1, C)
        b, w, c = core
        return (_batch_first(b, mesh), None,
                "model" if _fits(c, mesh, "model") else None)
    if name == "h":                                     # (B, w) rglru state
        b, w = core
        return (_batch_first(b, mesh),
                "model" if _fits(w, mesh, "model") else None)
    return (None,) * len(core)


# ----------------------------------------------------------- placements
#: the mesh dim of a batch-flattened multi-pod mesh, and the axes it joins
BATCH_DIM = "pod_data"
_JOINED = {BATCH_DIM: ("pod", "data")}


def flat_batch_mesh(mesh):
    """A ("pod", "data", "model") mesh as a 2-D (``BATCH_DIM``,
    "model") mesh, pod and data flattened into one dim, or None for a
    mesh without a pod axis. Specs place on it unchanged as long as they
    name pod and data together, as ("pod", "data"); DTensor plans
    redistributions of a 2-D mesh in a fraction of the time it takes for
    two mesh dims that shard one tensor dim."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    sizes = axis_sizes(mesh)
    if names != ("pod", "data", "model"):
        raise ValueError(f"flat_batch_mesh takes a (pod, data, model) "
                         f"mesh, got {names}")
    return init_device_mesh(mesh.device_type,
                            (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=(BATCH_DIM, "model"))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where that axis names tensor dim ``d``, else
    ``Replicate()``. A dim over ("pod", "data") is two ``Shard(d)``
    entries, in mesh order, or one on a :func:`flat_batch_mesh`."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for joined, parts in _JOINED.items():
            if joined in mesh.mesh_dim_names and any(
                    a in parts for a in names):
                if tuple(a for a in names if a in parts) != parts:
                    raise ValueError(f"spec {spec} names part of "
                                     f"{parts}: no dim of {mesh} holds it")
                names = tuple(a for a in names if a not in parts) \
                    + (joined,)
        for a in names:
            if a is not None:
                if a in where:
                    raise ValueError(f"axis {a!r} named twice in {spec}")
                where[a] = d
    out = tuple(Shard(where.pop(a)) if a in where else Replicate()
                for a in mesh.mesh_dim_names)
    if where:
        raise ValueError(f"spec {spec} names axes {sorted(where)} not in "
                         f"the mesh {mesh.mesh_dim_names}")
    return out


def _tree_paths(tree, prefix: str = ""):
    """(path, leaf) of nested dicts / lists, dict keys in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` as a DTensor with ``spec``'s placements on ``mesh``. A meta
    tensor gets its local shard shape directly (no data to scatter)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    place = placements(spec, mesh)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh, place)
    local = list(t.shape)
    for p, n in zip(place, mesh.shape):
        if p.is_shard():
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does "
                                 f"not divide over {n}")
            local[p.dim] //= n
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), mesh, place,
        run_check=False, shape=t.shape, stride=t.stride())


def distribute_params(params: PyTree, mesh, *, fsdp: bool,
                      layout=None) -> PyTree:
    """Params as DTensors: specs from ``mesh``'s axes, placed on
    ``layout`` (a :func:`flat_batch_mesh` of it) or on ``mesh``."""
    return _map_paths(lambda p, t: distribute(
        t, layout or mesh, param_spec(p, tuple(t.shape), mesh, fsdp=fsdp)),
        params)


def opt_state_spec(path: str, shape: tuple, mesh, *, fsdp: bool) -> Spec:
    """m/v follow params; step is replicated."""
    if path.endswith("step"):
        return (None,) * len(shape)
    core = path.split("/", 1)[1] if "/" in path else path
    return param_spec(core, shape, mesh, fsdp=fsdp)


def distribute_opt_state(opt_state: PyTree, mesh, *, fsdp: bool,
                         layout=None) -> PyTree:
    return _map_paths(lambda p, t: distribute(
        t, layout or mesh, opt_state_spec(p, tuple(t.shape), mesh,
                                          fsdp=fsdp)), opt_state)


def distribute_batch(batch: PyTree, mesh, layout=None) -> PyTree:
    """Training/prefill batches and decode tokens: batch dim over the
    batch axes."""
    return _map_paths(lambda p, t: distribute(
        t, layout or mesh, batch_spec(tuple(t.shape), mesh)), batch)


def distribute_cache(cache: PyTree, mesh, cfg=None, *, long_context: bool,
                     layout=None) -> PyTree:
    return _map_paths(lambda p, t: distribute(
        t, layout or mesh, cache_spec(p, tuple(t.shape), mesh, cfg,
                                      long_context=long_context)), cache)
