"""The port's sharding rules against the reference's, live.

``repro_torch.distributed.sharding``'s specs are held to
``repro.distributed.sharding``'s on every leaf of all ten full-size
configs: params (both production meshes, FSDP on and off), optimizer
state, decode caches at decode_32k and long_500k, training / prefill
batches and decode tokens. The reference's meshes are ``AbstractMesh``
(no devices); the port's rules take axis sizes. The reference stacks
each pattern period's layers (``blocks/layer{j}``, a leading period
axis) and the encoder-decoder's (``enc_blocks`` / ``dec_blocks``); the
port unrolls them (``layers/{i}``), so port layer i is held to
``blocks/layer{i % period}`` or to ``remainder/[i - n_periods *
period]``, with the reference's leading stacked None dropped.

Then: ``tests/test_sharding.py``'s tables restated against the port;
placements on fake 4x4 and 2x2x2 meshes (local shard shapes); and the
hooks, which return their argument itself on plain tensors and outside
a configured context.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as rs
from repro.models import model as ref_model
from repro_torch.configs.base import REFERENCE_IDS, SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as meshes
from repro_torch.launch import specs

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def ref_mesh(kind: str) -> AbstractMesh:
    sizes = MESHES[kind]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def norm_entry(e):
    """PartitionSpec's equality: a 1-tuple of names is that name."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def norm(spec) -> tuple:
    return tuple(norm_entry(e) for e in spec)


def ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {rs._path_str(p): leaf for p, leaf in flat}


def ref_path(cfg, path: str, cache: bool = False) -> tuple[str, int]:
    """(the reference's path of a port leaf, its leading stacked dims)."""
    parts = path.split("/")
    if cfg.is_encoder_decoder:
        if parts[0] in ("enc_layers", "dec_layers"):
            if cache:
                raise ValueError(path)
            return f"{parts[0][:3]}_blocks/" + "/".join(parts[2:]), 1
        if parts[0] == "layers" and cache:      # the decoder's caches
            name = parts[-1]
            return {"k": "self_k", "v": "self_v", "pos": "self_pos"}.get(
                name, name), 1
        return path, 0
    if parts[0] != "layers":
        return path, 0
    i = int(parts[1])
    full = cfg.n_periods * cfg.period
    rest = "/".join(parts[2:])
    if i < full:
        return f"blocks/layer{i % cfg.period}/{rest}", 1
    return f"remainder/[{i - full}]/{rest}", 0


def _port_leaves(tree) -> dict:
    return dict(sharding._tree_paths(tree))


@pytest.fixture(scope="module")
def shapes():
    out = {}
    for arch in REFERENCE_IDS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        out[arch] = (cfg, specs.params_specs(cfg),
                     ref_leaves(ref_model.param_shapes(rcfg)))
    return out


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_param_spec_matches_reference(shapes, arch, mesh_kind, fsdp):
    cfg, params, ref = shapes[arch]
    rmesh = ref_mesh(mesh_kind)
    leaves = _port_leaves(params)
    seen = set()
    for path, t in leaves.items():
        rpath, lead = ref_path(cfg, path)
        rleaf = ref[rpath]
        assert tuple(rleaf.shape[lead:]) == tuple(t.shape), path
        want = norm(rs.param_spec(rpath, rleaf.shape, rmesh, fsdp=fsdp))
        assert want[:lead] == (None,) * lead
        got = norm(sharding.param_spec(path, tuple(t.shape),
                                       MESHES[mesh_kind], fsdp=fsdp))
        assert got == want[lead:], (path, got, want)
        seen.add(rpath)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_opt_state_spec_matches_reference(shapes, arch, mesh_kind):
    cfg, params, ref = shapes[arch]
    rcfg = ref_get_config(arch)
    from repro.training import optimizer as ref_opt
    ocfg = ref_opt.AdamWConfig(state_dtype=rcfg.opt_state_dtype)
    rshapes = ref_model.param_shapes(rcfg)
    rstate = jax.eval_shape(lambda p: ref_opt.init_opt_state(p, ocfg),
                            rshapes)
    rspecs = {k: norm(v.spec) for k, v in ref_leaves(rs.opt_state_sharding(
        rstate, ref_mesh(mesh_kind), fsdp=True)).items()}
    state = specs.opt_state_specs(cfg)
    for path, t in _port_leaves(state).items():
        got = norm(sharding.opt_state_spec(path, tuple(t.shape),
                                           MESHES[mesh_kind], fsdp=True))
        if path == "step":
            assert got == () == rspecs["step"]
            continue
        head, rest = path.split("/", 1)
        rpath, lead = ref_path(cfg, rest)
        want = rspecs[f"{head}/{rpath}"]
        assert got == want[lead:], (path, got, want)
        assert t.dtype == getattr(torch, cfg.opt_state_dtype)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_cache_spec_matches_reference(arch, shape_name, mesh_kind):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    long_ctx = shape.global_batch == 1
    rcache = ref_leaves(jax.eval_shape(lambda: ref_model.init_cache(
        rcfg, shape.global_batch, shape.seq_len)))
    cache = specs.cache_specs(cfg, shape.global_batch, shape.seq_len)
    rmesh = ref_mesh(mesh_kind)
    for path, t in _port_leaves(cache).items():
        rpath, lead = ref_path(cfg, path, cache=True)
        rleaf = rcache[rpath]
        assert tuple(rleaf.shape[lead:]) == tuple(t.shape), path
        want = norm(rs.cache_spec(rpath, rleaf.shape, rmesh, rcfg,
                                  long_context=long_ctx))
        got = norm(sharding.cache_spec(path, tuple(t.shape),
                                       MESHES[mesh_kind], cfg,
                                       long_context=long_ctx))
        assert got == want[lead:], (path, got, want)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", REFERENCE_IDS)
def test_batch_and_token_specs_match_reference(arch, shape_name, mesh_kind):
    from repro.launch import specs as ref_specs
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    rmesh = ref_mesh(mesh_kind)
    if shape.kind == "decode":
        got = [specs.decode_token_specs(cfg, shape)[0]]
        want = [rs.token_sharding((shape.global_batch,), rmesh).spec]
    else:
        make = specs.train_batch_specs if shape.kind == "train" \
            else specs.prefill_batch_specs
        rmake = ref_specs.train_batch_specs if shape.kind == "train" \
            else ref_specs.prefill_batch_specs
        batch = make(cfg, shape)
        rbatch = rmake(rcfg, shape)
        assert sorted(batch) == sorted(rbatch)
        rsh = rs.batch_sharding(rbatch, rmesh)
        got = [batch[k] for k in sorted(batch)]
        want = [rsh[k].spec for k in sorted(batch)]
    for t, w in zip(got, want):
        assert norm(sharding.batch_spec(tuple(t.shape), MESHES[mesh_kind])) \
            == norm(w)


# ------------------------------------------------ the reference's tables
M16 = MESHES["single"]
MPOD = MESHES["multi"]


class TestReferenceTables:
    """``tests/test_sharding.py``'s cases on the port (no leading
    stacked axis: the port unrolls its layers)."""

    def test_attention_heads_divisible(self):
        s = sharding.param_spec("layers/0/attn/wq", (18432, 96, 192), M16,
                                fsdp=True)
        assert norm(s) == ("data", "model", None)

    def test_attention_heads_not_divisible_falls_back(self):
        s = sharding.param_spec("layers/0/attn/wq", (5120, 40, 128), M16,
                                fsdp=True)
        assert norm(s) == ("data", None, None)

    def test_kv_heads_replicated_when_small(self):
        s = sharding.param_spec("layers/0/attn/wk", (6144, 8, 128), M16,
                                fsdp=True)
        assert s[1] is None

    def test_mlp(self):
        s = sharding.param_spec("layers/0/mlp/wi", (4608, 36864), M16,
                                fsdp=True)
        assert norm(s) == ("data", "model")
        s = sharding.param_spec("layers/0/mlp/wo", (36864, 4608), M16,
                                fsdp=True)
        assert norm(s) == ("model", "data")

    def test_moe_expert_parallel(self):
        s = sharding.param_spec("layers/0/moe/wi", (16, 6144, 10752), M16,
                                fsdp=True)
        assert norm(s) == ("model", "data", None)

    def test_embed_vocab_sharding_guard(self):
        ok = sharding.param_spec("embed", (256000, 4608), M16, fsdp=True)
        assert norm(ok) == ("model", "data")
        bad = sharding.param_spec("embed", (51865, 768), M16, fsdp=True)
        assert norm(bad) == (None, "data")

    def test_serve_mode_disables_fsdp(self):
        s = sharding.param_spec("layers/0/mlp/wi", (4608, 36864), M16,
                                fsdp=False)
        assert norm(s) == (None, "model")

    def test_multipod_fsdp_uses_pod_axis(self):
        s = sharding.param_spec("layers/0/mlp/wi", (4608, 36864), MPOD,
                                fsdp=True)
        assert norm(s) == (("pod", "data"), "model")

    def test_norms_replicated(self):
        s = sharding.param_spec("layers/0/norm1/scale", (4608,), M16,
                                fsdp=True)
        assert norm(s) == (None,)

    def test_kv_heads_over_model(self):
        s = sharding.cache_spec("layers/0/k", (128, 32768, 16, 128), M16,
                                None, long_context=False)
        assert norm(s) == ("data", None, "model", None)

    def test_kv_seq_fallback(self):
        s = sharding.cache_spec("layers/0/k", (128, 32768, 8, 128), M16,
                                None, long_context=False)
        assert norm(s) == ("data", "model", None, None)

    def test_long_context_shards_sequence_over_data(self):
        s = sharding.cache_spec("layers/0/k", (1, 524288, 16, 128), M16,
                                None, long_context=True)
        assert norm(s) == (None, "data", "model", None)

    def test_ssm_state(self):
        s = sharding.cache_spec("layers/0/ssm", (128, 32, 64, 128), M16,
                                None, long_context=False)
        assert norm(s) == ("data", "model", None, None)

    def test_whisper_cross_cache(self):
        s = sharding.cache_spec("layers/0/cross_k", (128, 32768, 12, 64),
                                M16, None, long_context=False)
        assert norm(s) == ("data", "model", None, None)


# ------------------------------------------------------------ placements
@pytest.fixture
def fake_mesh(request):
    """A fake-group mesh of ``request.param`` (shape, axes), CPU device
    type, torn down after the test."""
    shape, axes = request.param
    meshes.destroy()
    mesh = meshes.make_debug_mesh(*shape, device="cpu") if len(shape) == 2 \
        else meshes.make_mesh(shape, axes, device="cpu")
    assert meshes.chips(mesh) == int(np.prod(shape))
    yield mesh
    meshes.destroy()


MESH_CASES = [((4, 4), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model"))]


@pytest.mark.parametrize("fake_mesh", MESH_CASES, indirect=True,
                         ids=["4x4", "2x2x2"])
def test_local_shards_are_global_over_axis_sizes(fake_mesh):
    sizes = sharding.axis_sizes(fake_mesh)
    ba = sharding.batch_axes(fake_mesh)
    nb = int(np.prod([sizes[a] for a in ba]))
    cases = [((ba, "model"), (8 * nb, 12)), ((None, "model"), (3, 8)),
             (("model", None, ba), (4, 5, 2 * nb)), ((None,), (7,))]
    for spec, shape in cases:
        for dev in ("meta", "cpu"):
            t = torch.zeros(shape, device=dev)
            d = sharding.distribute(t, fake_mesh, spec)
            want = list(shape)
            for dim, entry in enumerate(spec):
                names = entry if isinstance(entry, tuple) else (entry,)
                for a in names:
                    if a is not None:
                        want[dim] //= sizes[a]
            assert tuple(d.shape) == shape
            assert list(d.to_local().shape) == want, (spec, dev)
    pl = sharding.placements((ba, None, "model"), fake_mesh)
    shard_dims = [p.dim if p.is_shard() else None for p in pl]
    assert shard_dims == [0] * len(ba) + [2]


@pytest.mark.parametrize("fake_mesh", MESH_CASES[1:], indirect=True,
                         ids=["2x2x2"])
def test_flat_batch_mesh_places_pod_data_as_one_dim(fake_mesh):
    flat = sharding.flat_batch_mesh(fake_mesh)
    assert flat.mesh_dim_names == (sharding.BATCH_DIM, "model")
    assert tuple(flat.shape) == (4, 2)
    d = sharding.distribute(torch.zeros((8, 6), device="meta"), flat,
                            (("pod", "data"), "model"))
    assert tuple(d.to_local().shape) == (2, 3)
    with pytest.raises(ValueError):
        sharding.placements(("data", None), flat)


@pytest.mark.parametrize("fake_mesh", MESH_CASES[:1], indirect=True,
                         ids=["4x4"])
def test_hooks_redistribute_dtensors(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = sharding.distribute(torch.zeros((8, 4, 16), device="meta"),
                            fake_mesh, (None, None, "model"))
    sharding.set_activation_batch_axes(("data",))
    try:
        y = sharding.constrain_batch(x)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert sharding.constrain_batch(y) is y
    finally:
        sharding.set_activation_batch_axes(None)
    assert sharding.constrain_batch(x) is x
    sharding.set_moe_expert_axis("model", groups=4)
    try:
        buf = sharding.distribute(torch.zeros((4, 8, 2, 6), device="meta"),
                                  fake_mesh, (None,) * 4)
        assert tuple(sharding.constrain_moe_buffer(buf).placements) == \
            (Replicate(), Shard(1))
        w = sharding.distribute(torch.zeros((8, 8, 4), device="meta"),
                                fake_mesh, ("model", "data", None))
        assert tuple(sharding.constrain_moe_weight(w).placements) == \
            (Replicate(), Shard(0))
    finally:
        sharding.set_moe_expert_axis(None, groups=1)


@pytest.mark.parametrize("fake_mesh", MESH_CASES[:1], indirect=True,
                         ids=["4x4"])
def test_take_last_and_ring_write_on_shards(fake_mesh):
    """The two local repairs, on real CPU data over a fake group: every
    rank is rank 0 here, so only rank 0's shard can be checked."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((8, 3, 32), generator=gen)
    labels = torch.randint(0, 32, (8, 3), generator=gen)
    d = sharding.distribute(logits, fake_mesh, ("data", None, "model"))
    gold = sharding.take_last(d, sharding.distribute(
        labels, fake_mesh, ("data", None)))
    local = gold.to_local()
    want = torch.gather(logits[:2], -1, labels[:2, :, None])[..., 0]
    inside = labels[:2] < 8          # rank 0's vocab shard: columns 0..7
    assert torch.equal(local, torch.where(inside, want, 0.0))

    cache = torch.zeros((8, 16, 4))
    dc = sharding.distribute(cache.clone(), fake_mesh, ("data", "model",
                                                        None))
    slot = torch.tensor([0, 5, 3, 12, 1, 2, 3, 4])
    val = torch.arange(8 * 4, dtype=torch.float32).view(8, 4)
    sharding.ring_write(dc, sharding.distribute(slot, fake_mesh, ("data",)),
                        sharding.distribute(val, fake_mesh,
                                            ("data", None)))
    want = cache.clone()
    want[torch.arange(8), slot] = val
    # rank 0 holds rows 0..1 and slots 0..3
    assert torch.equal(dc.to_local(), want[:2, :4])


def test_hooks_return_plain_tensors_themselves():
    x = torch.ones((4, 8))
    w = torch.ones((2, 3, 4))
    assert sharding.constrain_batch(x) is x
    assert sharding.constrain_moe_groups(x) is x
    assert sharding.constrain_moe_buffer(w) is w
    assert sharding.constrain_moe_weight(w) is w
    assert sharding.unflattenable(x, (2, 4)) is x
    sharding.set_activation_batch_axes(("data",))
    sharding.set_moe_expert_axis("model", groups=2)
    try:
        assert sharding.constrain_batch(x) is x
        assert sharding.constrain_moe_groups(x) is x
        assert sharding.constrain_moe_buffer(w) is w
        assert sharding.constrain_moe_weight(w) is w
        assert sharding.moe_num_groups() == 2
    finally:
        sharding.set_activation_batch_axes(None)
        sharding.set_moe_expert_axis(None, groups=1)
    assert sharding.moe_num_groups() == 1
    assert sharding._ACT_BATCH_AXES is None


def test_plain_ring_write_is_an_index_put():
    cache = torch.zeros((3, 5, 2))
    slot = torch.tensor([4, 0, 2])
    val = torch.arange(6, dtype=torch.float32).view(3, 2)
    sharding.ring_write(cache, slot, val)
    want = torch.zeros((3, 5, 2))
    want[torch.arange(3), slot] = val
    assert torch.equal(cache, want)
    x = torch.randn((2, 3, 7), generator=torch.Generator().manual_seed(1))
    idx = torch.tensor([[0, 6, 3], [1, 1, 5]])
    assert torch.equal(sharding.take_last(x, idx),
                       torch.gather(x, -1, idx[..., None])[..., 0])


# ------------------------------------------------------------ MoE groups
def moe_before(params: dict, x: torch.Tensor, *, top_k: int, kind: str,
               capacity_factor: float = 1.25):
    """The port's ``layers.moe`` as it was before token groups (one group
    of all tokens), kept verbatim: groups of 1 must equal it bit for
    bit."""
    import torch.nn.functional as F
    from repro_torch.models.layers import _bmm_f32, moe_capacity
    b, s, d = x.shape
    t = b * s
    e = params["router"].shape[1]
    xf = x.reshape(t, d)
    probs = torch.softmax(torch.matmul(xf.to(torch.float32),
                                       params["router"]), dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = order[:, :top_k]
    gates = ranked[:, :top_k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    chosen = torch.zeros((t, e), dtype=torch.float32, device=x.device) \
        .scatter_(1, gate_idx, 1.0)
    aux = e * torch.sum(probs.mean(dim=0) * chosen.mean(dim=0))
    cap = moe_capacity(t, top_k, e, capacity_factor)
    hits = chosen.to(torch.int64)
    rank = (torch.cumsum(hits, dim=0) - hits).gather(1, gate_idx)
    keep = rank < cap
    slot = gate_idx * cap + torch.clamp_max(rank, cap - 1)
    src = torch.where(keep[..., None], xf[:, None, :],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device) \
        .index_add_(0, torch.where(keep, slot, e * cap - 1).reshape(-1),
                    src.reshape(-1, d)).view(e, cap, d)
    h = torch.bmm(buf, params["wi"])
    if kind == "swiglu":
        h = (F.silu(_bmm_f32(buf, params["wg"]))
             * h.to(torch.float32)).to(x.dtype)
    elif kind == "geglu":
        h = (F.gelu(_bmm_f32(buf, params["wg"]), approximate="tanh")
             * h.to(torch.float32)).to(x.dtype)
    elif kind == "relu2":
        h = F.relu(h.to(torch.float32)).square().to(x.dtype)
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    out = torch.bmm(h, params["wo"]).view(e * cap, d)
    part = out[slot] * (gates * keep).to(x.dtype)[..., None]
    part = part.gather(1, torch.argsort(gate_idx, dim=1)[..., None]
                       .expand(-1, -1, d))
    y = part[:, 0]
    for j in range(1, top_k):
        y = y + part[:, j]
    return y.reshape(b, s, d), aux


def reference_grouped_moe(monkeypatch, params: dict, x, groups: int, **kw):
    """The reference layer under ``set_moe_expert_axis(None, groups)``:
    (y, aux, experts (T, k), kept (T, k)), its routing read from its
    ``lax.top_k`` and the record its dispatch hands its combine."""
    from repro.models import layers as jl
    from test_torch_moe import f32_einsum
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
    rs.set_moe_expert_axis(None, groups=groups)
    try:
        with monkeypatch.context() as m:
            m.setattr(jax.lax, "top_k", rec_top_k)
            m.setattr(jax, "vmap", rec_vmap)
            m.setattr(jnp, "einsum", f32_einsum(jnp.einsum))
            y, aux = jl.moe(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), **kw)
    finally:
        rs.set_moe_expert_axis(None, groups=1)
    gate_idx = np.asarray(seen["top"][1])                   # (G, Tg, k)
    g, tg, k = gate_idx.shape
    slot, tok, _, keep = (np.asarray(a) for a in seen["info"])
    e = params["router"].shape[1]
    cap = int(max(1, round(tg * k / e * kw.get("capacity_factor", 1.25))))
    kept = np.zeros(gate_idx.shape, bool)
    for gi in range(g):
        for s_, t_, k_ in zip(slot[gi], tok[gi], keep[gi]):
            j = int(np.nonzero(gate_idx[gi, t_] == s_ // cap)[0][0])
            kept[gi, t_, j] = k_
    return (np.asarray(y), float(aux), gate_idx.reshape(g * tg, k),
            kept.reshape(g * tg, k))


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b"])
def test_moe_groups_match_reference(arch, groups, monkeypatch):
    """Token groups (the reference's data-local dispatch, each group with
    its own capacity): the port and the reference under the same group
    count, on reduced DBRX-132B and Arctic-480B. 48 tokens leaning to
    expert 0 so that some choices drop."""
    from repro_torch.models import layers as tl
    from test_torch_moe import assert_no_near_tie, layer_params, moe_params
    _, _, tc, tp = moe_params(arch)
    rng = np.random.default_rng(70)
    u = rng.normal(size=tc.d_model)
    u /= np.linalg.norm(u)
    p = {k: v.clone() for k, v in layer_params(tp).items()}
    p["router"][:, 0] += torch.from_numpy(3.0 * u).float()
    x = (rng.normal(size=(3, 16, tc.d_model)) + 1.5 * u).astype(np.float32)
    kw = dict(top_k=tc.top_k, kind=tc.mlp_kind)
    jy, jaux, j_idx, j_keep = reference_grouped_moe(
        monkeypatch, {k: v.numpy() for k, v in p.items()}, x, groups, **kw)
    record: list = []
    monkeypatch.setattr(tl, "MOE_RECORD", record)
    sharding.set_moe_expert_axis(None, groups=groups)
    try:
        ty, taux = tl.moe(p, torch.from_numpy(x), **kw)
    finally:
        sharding.set_moe_expert_axis(None, groups=1)
    assert_no_near_tie(record)
    np.testing.assert_array_equal(record[-1]["gate_idx"].numpy(), j_idx)
    np.testing.assert_array_equal(record[-1]["keep"].numpy(), j_keep)
    assert (~j_keep).sum() > 0
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-5, rtol=1e-5)
    assert abs(float(taux) - jaux) <= 1e-6
    if groups == 1:
        by, baux = moe_before(p, torch.from_numpy(x), **kw)
        assert torch.equal(ty, by) and torch.equal(taux, baux)


def test_moe_groups_fall_back_to_one_when_they_do_not_divide():
    from repro_torch.models import layers as tl
    from test_torch_moe import layer_params, moe_params
    _, _, tc, tp = moe_params("dbrx_132b")
    x = torch.from_numpy(np.random.default_rng(71).normal(
        size=(1, 7, tc.d_model)).astype(np.float32))
    sharding.set_moe_expert_axis(None, groups=4)
    try:
        y4, a4 = tl.moe(layer_params(tp), x, top_k=tc.top_k,
                        kind=tc.mlp_kind)
    finally:
        sharding.set_moe_expert_axis(None, groups=1)
    y1, a1 = moe_before(layer_params(tp), x, top_k=tc.top_k,
                        kind=tc.mlp_kind)
    assert torch.equal(y4, y1) and torch.equal(a4, a1)
