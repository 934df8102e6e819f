"""Carry state across from the JAX package's host arrays.

The routing layer's state is the candidate table (one row of
latency-law parameters per deployment) and the Erlang-C wait table:
:func:`candidate_table_from_numpy` takes them as plain numpy arrays —
e.g. the columns of a reference ``CandidateTable`` and a
``build_erlang_table`` output — and returns the port's device-resident
columns, ready for ``repro_torch.kernels.ops``. The model stack's state
is its weights: :func:`model_params_from_numpy` takes a reference
``init_params`` pytree with numpy leaves and returns the port's
parameters, and :func:`opt_state_from_numpy` its AdamW state. Only
numpy crosses the boundary, so this module imports
neither framework's package. :func:`falcon_h1_params` maps a published
Falcon-H1 state dict (``transformers``' ``FalconH1ForCausalLM`` names)
to the port's tree, with the model's muP multipliers folded into the
weights.
"""
from __future__ import annotations

import numpy as np
import torch

#: float32 candidate columns, each (I,)
F32_COLUMNS = ("alpha", "beta", "gamma", "mu", "rtt", "cost", "tau", "n")
#: optional float32 (I,) columns: the ``reliable`` policy's per-candidate
#: log-dispersion and delivery probability (``routing_attain``)
OPTIONAL_COLUMNS = ("sigma", "avail")


def candidate_table_from_numpy(cols: dict, erlang_table, device="cuda"
                               ) -> dict[str, torch.Tensor]:
    """Device-resident candidate table from numpy columns.

    ``cols`` maps ``alpha``, ``beta``, ``gamma``, ``mu``, ``rtt``,
    ``cost``, ``tau`` and ``n`` to (I,) arrays and ``upstream`` to an
    (I,) int array (-1 at the top tier), and may map ``sigma`` and
    ``avail`` to (I,) arrays (a reference ``ReliableSloPolicy``'s
    ``_sigma`` / ``_avail``); ``erlang_table`` is (I, T). Returns float32
    tensors for those columns, ``upstream`` as int32 and the table under
    ``"erlang_table"``, all contiguous on ``device`` and copied, so they
    never alias the caller's arrays.
    """
    n_cand = len(np.asarray(cols["alpha"]))
    out: dict[str, torch.Tensor] = {}
    for name in F32_COLUMNS + tuple(c for c in OPTIONAL_COLUMNS
                                    if c in cols):
        arr = np.ascontiguousarray(np.asarray(cols[name]), np.float32)
        if arr.shape != (n_cand,):
            raise ValueError(f"column {name!r}: shape {arr.shape}, "
                             f"expected ({n_cand},)")
        out[name] = torch.tensor(arr, device=device)
    up = np.ascontiguousarray(np.asarray(cols["upstream"]), np.int32)
    if up.shape != (n_cand,) or (up >= n_cand).any() or (up < -1).any():
        raise ValueError(f"upstream column {up!r} is not a column map "
                         f"over {n_cand} candidates")
    out["upstream"] = torch.tensor(up, device=device)
    table = np.ascontiguousarray(np.asarray(erlang_table), np.float32)
    if table.ndim != 2 or table.shape[0] != n_cand:
        raise ValueError(f"erlang_table shape {table.shape}, expected "
                         f"({n_cand}, T)")
    out["erlang_table"] = torch.tensor(table, device=device)
    return out


def _leaves(tree, prefix: str = "") -> dict:
    """Flatten nested dicts / lists to {"a/b/0/c": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_leaves(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten_like(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten_like(v, flat, f"{prefix}/{i}" if prefix
                                else str(i)) for i, v in enumerate(like)]
    return flat[prefix]


def _to_torch(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: carry the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype)


def _unstack(tree, n: int, where: str) -> list[dict]:
    """Leaves of ``tree`` stacked over ``n`` layers -> ``n`` flat dicts,
    {"a/b": leaf[i]}; a leaf not stacked so raises ``ValueError``."""
    flat = _leaves(tree)
    for path, arr in flat.items():
        if np.ndim(arr) < 1 or np.shape(arr)[0] != n:
            raise ValueError(f"params: {where}/{path} shape "
                             f"{np.shape(arr)}: not stacked over {n}")
    return [{path: np.asarray(arr)[i] for path, arr in flat.items()}
            for i in range(n)]


def _decoder_layers(tree: dict, cfg) -> list[dict]:
    """A decoder-only tree's layers in order: the ``blocks`` periods
    unrolled, then the ``remainder`` list."""
    blocks = tree.get("blocks", {})
    extra = set(blocks) - {f"layer{j}" for j in range(cfg.period)}
    if extra:
        raise ValueError(f"params: unexpected blocks {sorted(extra)}")
    per_kind = []
    for j in range(cfg.period):
        if f"layer{j}" not in blocks:
            raise ValueError(f"params: blocks/layer{j} missing")
        per_kind.append(_unstack(blocks[f"layer{j}"], cfg.n_periods,
                                 f"blocks/layer{j}"))
    return [per_kind[j][p] for p in range(cfg.n_periods)
            for j in range(cfg.period)] \
        + [_leaves(rem) for rem in tree.get("remainder", [])]


def model_params_from_numpy(tree: dict, cfg, device="cuda",
                            dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a reference ``init_params`` pytree.

    ``tree`` has numpy leaves (``jax.tree.map(np.asarray, params)``). A
    decoder-only tree holds ``embed``, ``blocks`` (``layer{j}`` dicts
    stacked over the ``cfg.n_periods`` pattern periods), ``remainder`` (a
    list, when ``cfg.n_layers`` is not a multiple of the period),
    ``final_norm`` and ``lm_head`` unless tied; an encoder-decoder tree
    ``embed``, ``enc_blocks`` and ``dec_blocks`` (stacked over
    ``cfg.n_encoder_layers`` and ``cfg.n_layers``), ``enc_norm``,
    ``final_norm`` and ``lm_head``. Returns the layout of
    ``repro_torch.models.model.init_params(cfg)``: the stacks unrolled
    into one dict per layer, in order, each leaf a copy on ``device`` in
    the dtype of the port's init (a MoE router stays float32 in a bf16
    model, as in the reference), or in ``dtype`` when given. A leaf that
    is missing, extra or of the wrong shape raises ``ValueError``.
    """
    from repro_torch.models import model
    shapes = model.init_params(cfg, device="meta")
    want = _leaves(shapes)
    if cfg.is_encoder_decoder:
        stacked = ("enc_blocks", "dec_blocks")
        unrolled = {
            "enc_layers": _unstack(tree.get("enc_blocks", {}),
                                   cfg.n_encoder_layers, "enc_blocks"),
            "dec_layers": _unstack(tree.get("dec_blocks", {}), cfg.n_layers,
                                   "dec_blocks")}
    else:
        stacked = ("blocks", "remainder")
        unrolled = {"layers": _decoder_layers(tree, cfg)}
    got = {}
    for key, sub in tree.items():
        if key not in stacked:
            got.update(_leaves(sub, key))
    for name, layer_list in unrolled.items():
        for i, layer in enumerate(layer_list):
            got.update({f"{name}/{i}/{path}": arr
                        for path, arr in layer.items()})
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"params: missing {missing}, unexpected {extra}")
    flat = {}
    for path, like in want.items():
        if tuple(np.shape(got[path])) != tuple(like.shape):
            raise ValueError(f"params: {path} shape {np.shape(got[path])}, "
                             f"expected {tuple(like.shape)}")
        flat[path] = _to_torch(got[path], dtype or like.dtype, device)
    return _unflatten_like(shapes, flat)


def opt_state_from_numpy(opt_state: dict, cfg, device="cuda") -> dict:
    """The port's AdamW state from a reference ``init_opt_state`` /
    ``apply_updates`` state with numpy leaves: ``m`` and ``v`` through
    the layer mapping of :func:`model_params_from_numpy`, in
    ``cfg.opt_state_dtype``, and ``step`` as a 0-d int32 tensor."""
    dt = getattr(torch, cfg.opt_state_dtype)
    return {"m": model_params_from_numpy(opt_state["m"], cfg, device, dt),
            "v": model_params_from_numpy(opt_state["v"], cfg, device, dt),
            "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=device)}


def _mup_vector(cfg, ssm_multipliers) -> torch.Tensor:
    """The published ``compute_mup_vector``: one multiplier per column of
    the Mamba-2 in_proj output, by segment z, x, B, C, dt."""
    from repro_torch.models import ssm
    dd = ssm.dims(cfg)
    gn = dd["groups"] * dd["state"]
    sizes = [dd["d_in"], dd["d_in"], gn, gn, dd["n_heads"]]
    return torch.cat([torch.full((n,), float(m), dtype=torch.float32)
                      for n, m in zip(sizes, ssm_multipliers)])


def falcon_h1_params(state_dict: dict, cfg,
                     multipliers: dict | None = None) -> dict:
    """The port's tree of a Falcon-H1 stack (``cfg`` of
    ``"parallel_hybrid"`` layers) from a ``FalconH1ForCausalLM`` state
    dict, with the muP multipliers (``multipliers``, by default the
    published ones of
    ``repro_torch.configs.falcon_h1_34b.MULTIPLIERS``) folded into the
    weights, so the served model carries no multiplier pass:

    * ``embedding_multiplier`` into ``embed``, ``lm_head_multiplier``
      into ``lm_head``;
    * ``attention_in_multiplier`` into q, k and v, ``key_multiplier``
      into k (rotary is linear: scaling k before or after it is one),
      ``attention_out_multiplier`` into o;
    * ``ssm_in_multiplier`` and the five ``ssm_multipliers`` segments
      (``compute_mup_vector``) into the columns of ``in_proj``,
      ``ssm_out_multiplier`` into ``out_proj``;
    * ``mlp_multipliers`` into the gate (a SiLU reads it, after the
      product) and the down projection.

    Each fold is a product in float32 cast once to the model dtype. The
    published RMSNorm weights w become the port's scales w - 1 (the port
    computes ``x * (1 + scale)``), in float32. Layouts: every Linear
    (out, in) is transposed to the port's (in, out), attention split by
    head (``wq`` (d, H, hd), ``wo`` (H, hd, d)), the conv's (C, 1, W)
    taps to (W, C); every leaf stays on the state dict's device. A
    missing, extra or misshapen leaf raises ``ValueError``."""
    from repro_torch.models import model
    if multipliers is None:
        from repro_torch.configs.falcon_h1_34b import MULTIPLIERS
        multipliers = MULTIPLIERS
    mu = multipliers
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    used: set = set()

    def w(name: str) -> torch.Tensor:
        if name not in sd:
            raise ValueError(f"falcon_h1_params: no {name!r} in the state "
                             "dict")
        used.add(name)
        return sd[name].detach().to(torch.float32)

    def scale(name: str) -> torch.Tensor:
        return w(name) - 1.0

    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gm, dm = mu["mlp_multipliers"]
    attn_in = mu["attention_in_multiplier"]
    mup = _mup_vector(cfg, mu["ssm_multipliers"]) * mu["ssm_in_multiplier"]
    flat = {"embed": w("embed_tokens.weight") * mu["embedding_multiplier"],
            "final_norm/scale": scale("final_layernorm.weight")}
    if not cfg.tie_embeddings:
        flat["lm_head"] = w("lm_head.weight").T * mu["lm_head_multiplier"]
    for i in range(cfg.n_layers):
        src, dst = f"layers.{i}.", f"layers/{i}/"
        at, mb, ff = src + "self_attn.", src + "mamba.", src + "feed_forward."
        flat.update({
            dst + "norm1/scale": scale(src + "input_layernorm.weight"),
            dst + "norm2/scale": scale(src + "pre_ff_layernorm.weight"),
            dst + "attn/wq": (w(at + "q_proj.weight").T * attn_in)
            .reshape(d, h, hd),
            dst + "attn/wk": (w(at + "k_proj.weight").T
                              * (attn_in * mu["key_multiplier"]))
            .reshape(d, hkv, hd),
            dst + "attn/wv": (w(at + "v_proj.weight").T * attn_in)
            .reshape(d, hkv, hd),
            dst + "attn/wo": (w(at + "o_proj.weight").T
                              * mu["attention_out_multiplier"])
            .reshape(h, hd, d),
            dst + "mixer/in_proj": w(mb + "in_proj.weight").T * mup,
            dst + "mixer/conv_w": w(mb + "conv1d.weight")[:, 0, :].T,
            dst + "mixer/conv_b": w(mb + "conv1d.bias"),
            dst + "mixer/dt_bias": w(mb + "dt_bias"),
            dst + "mixer/a_log": w(mb + "A_log"),
            dst + "mixer/d_skip": w(mb + "D"),
            dst + "mixer/norm/scale": scale(mb + "norm.weight"),
            dst + "mixer/out_proj": w(mb + "out_proj.weight").T
            * mu["ssm_out_multiplier"],
            dst + "mlp/wg": w(ff + "gate_proj.weight").T * gm,
            dst + "mlp/wi": w(ff + "up_proj.weight").T,
            dst + "mlp/wo": w(ff + "down_proj.weight").T * dm,
        })
    extra = sorted(set(sd) - used)
    if extra:
        raise ValueError(f"falcon_h1_params: unexpected {extra}")
    shapes = model.init_params(cfg, device="meta")
    want = _leaves(shapes)
    if set(want) != set(flat):
        raise ValueError(f"falcon_h1_params: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(want))}")
    out = {}
    for path, like in want.items():
        if tuple(flat[path].shape) != tuple(like.shape):
            raise ValueError(f"falcon_h1_params: {path} shape "
                             f"{tuple(flat[path].shape)}, expected "
                             f"{tuple(like.shape)}")
        out[path] = flat[path].to(dtype=like.dtype).contiguous()
    return _unflatten_like(shapes, out)
