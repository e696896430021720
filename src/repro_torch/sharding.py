"""Logical-axis sharding rules of the model zoo (the port of the JAX
package's ``sharding.py``), as pure functions over a mesh's axis sizes.

Model code names the axes of each tensor logically (``ParamSchema.axes``:
"vocab", "embed", "heads", ...); a per-(config, mesh, mode) rule table maps
each name to mesh axes. A mapping holds only where the mesh axes' size
divides the dimension, else the dimension stays whole: this is how yi-34b
(56 heads on a 16-way "model" axis) falls back to head_dim sharding, which
the forward computes on too (``tensor_parallel.py``).

Here the mesh is explicit SPMD (``launch/mesh.py::GridMesh``): a rule table
decides which dimension a rank keeps a slice of: a parameter's "model"
dimension (``model_dims``; ``shard_params`` cuts a rank's slices from whole
leaves and ``gather_params`` rebuilds them), the ZeRO-1 dimension of the
optimizer state (``optim.opt_state_specs``), the rows of the batch
(``data.batch_rows``) and, in serving, each leaf of the decode state
(``state_specs``, the reference's ``launch/steps.py::_state_spec``: a KV
cache's sequence over the rules' "kv_seq"; ``local_slice`` gives a rank's
rows). ``mesh_shape`` is the ordered ``{axis: size}``
mapping (``GridMesh.shape``). The reference's ``use_sharding`` / ``shard``
/ ``named_sharding`` place GSPMD constraints and have no counterpart: the
forward computes on the slices with explicit collectives
(``tensor_parallel.py``).
"""
from __future__ import annotations

from typing import Mapping, Sequence

__all__ = ["AxisRules", "logical_spec", "make_rules", "axis_size",
           "model_dims", "shard_params", "gather_params", "state_names",
           "state_specs", "local_shape", "local_slice", "flat_tree",
           "nest_tree"]

# the logical names whose "model" slice the forward computes on
# (``tensor_parallel.py``); any other name resolved to "model" raises
MODEL_SLICED = frozenset({"vocab", "heads", "kv_heads", "head_dim", "mlp",
                          "experts", "expert_mlp"})

# logical axis name -> mesh axis name, tuple of names, or None
AxisRules = dict


def axis_size(mesh_shape: Mapping[str, int], phys) -> int:
    """The number of ranks of mesh axis ``phys`` (a name, a tuple of names
    or None)."""
    if phys is None:
        return 1
    if isinstance(phys, (tuple, list)):
        n = 1
        for a in phys:
            n *= mesh_shape[a]
        return n
    return mesh_shape[phys]


def logical_spec(names: Sequence[str | None], shape: Sequence[int] | None,
                 mesh_shape: Mapping[str, int], rules: AxisRules) -> tuple:
    """Resolve logical names to mesh axes per dimension (the reference's
    ``PartitionSpec`` as a tuple): a mapping whose mesh axes are already
    taken by an earlier dimension, or (with ``shape``) whose size does not
    divide the dimension, is dropped. A single mesh axis is given by its
    name, several by a tuple (as ``PartitionSpec`` writes them)."""
    out = []
    used: set = set()
    for i, name in enumerate(names):
        phys = rules.get(name) if name is not None else None
        if phys is not None:
            flat = tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)
            if any(a in used for a in flat):
                phys = None
            elif shape is not None and shape[i] % axis_size(mesh_shape,
                                                             phys) != 0:
                phys = None
            else:
                used.update(flat)
        if isinstance(phys, (tuple, list)):
            phys = phys[0] if len(phys) == 1 else tuple(phys)
        out.append(phys)
    return tuple(out)


def make_rules(cfg, mesh_shape: Mapping[str, int], mode: str = "train",
               decode_batch: int | None = None,
               strategy: str = "tp") -> AxisRules:
    """The logical -> mesh table of a config on a mesh, the reference's
    ``make_rules`` rule for rule: 'tp' shards heads (or head_dim), mlp,
    vocab and experts over "model" where it divides them; 'tp_sp' shards
    the residual stream's sequence instead of d_model; 'fsdp' (train)
    shards the batch over every axis and no weight over "model" but the
    vocab; 'decode' shards the KV cache's length over "model" (and over
    the data axes too when the batch cannot use them)."""
    axes = dict(mesh_shape)
    model = "model" if "model" in axes else None
    data: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in axes)
    msize = axes.get("model", 1)

    if strategy == "fsdp" and mode == "train":
        full = data + ((model,) if model else ())
        return {
            "batch": full, "seq": None, "embed": None,
            "residual_embed": None,
            "vocab": model, "mlp": None, "heads": None, "kv_heads": None,
            "head_dim": None, "experts": None, "expert_mlp": None,
            "layers": None, "kv_seq": None, "state": None, "frames": None,
        }

    def div(n: int) -> bool:
        return model is not None and n > 0 and n % msize == 0

    heads_sharded = div(getattr(cfg, "h_eff", getattr(cfg, "n_heads", 0)))
    rules: AxisRules = {
        "batch": data,
        "seq": None,
        "embed": None,
        "residual_seq": model if strategy == "tp_sp" else None,
        "residual_embed": (model if (strategy != "tp_sp"
                                     and div(getattr(cfg, "d_model", 0)))
                           else None),
        "vocab": model if div(getattr(cfg, "vocab_padded", 0)) else None,
        "mlp": model if div(getattr(cfg, "d_ff", 0)) else None,
        "heads": model if heads_sharded else None,
        "kv_heads": (model if div(getattr(cfg, "kv_eff",
                                          getattr(cfg, "n_kv_heads", 0)))
                     else None),
        "head_dim": (model if (not heads_sharded
                               and div(getattr(cfg, "d_head", 0)))
                     else None),
        "experts": model if div(getattr(cfg, "n_experts", 0)) else None,
        "expert_mlp": None,
        "layers": None,
        "kv_seq": None,
        "state": None,
        "frames": None,
    }
    if getattr(cfg, "n_experts", 0) and not div(cfg.n_experts):
        rules["expert_mlp"] = model if div(cfg.d_ff) else None
    if mode == "decode":
        bsz = decode_batch
        if bsz is not None and data and bsz % axis_size(axes, data) != 0:
            rules["batch"] = None
            rules["kv_seq"] = tuple(data) + ((model,) if model else ())
        else:
            rules["kv_seq"] = model
    return rules


def _has_model(phys) -> bool:
    flat = phys if isinstance(phys, (tuple, list)) else (phys,)
    return "model" in flat


def model_dims(param_axes: Mapping[str, tuple], param_shapes: Mapping,
               mesh_shape: Mapping[str, int], rules: AxisRules) -> dict:
    """Each leaf's dimension that the "model" axis slices under ``rules``
    (None: whole on every rank of the axis), as ``optim.zero_dims`` gives
    ZeRO-1's. "head_dim" is the rules' fallback where the heads do not
    divide (``tensor_parallel.TensorParallel.head_dim_sliced``). Raises
    ``NotImplementedError`` for a name the forward has no sliced form of
    ("residual_embed", which no leaf carries)."""
    out = {}
    for k, axes in param_axes.items():
        spec = logical_spec(axes, param_shapes[k], mesh_shape, rules)
        dims = [i for i, phys in enumerate(spec) if _has_model(phys)]
        if dims and mesh_shape.get("model", 1) > 1:
            name = axes[dims[0]]
            if name not in MODEL_SLICED:
                raise NotImplementedError(
                    f"{k}: its {name!r} dimension resolves to \"model\"; "
                    "the forward has no sliced form of it")
        out[k] = dims[0] if dims else None
    return out


def shard_params(full: dict, dims: Mapping, mesh) -> dict:
    """This rank's slices of whole leaves ``full``: leaf ``k`` cut along
    ``dims[k]`` into ``mesh.shape["model"]`` equal parts, the part of this
    rank's "model" coordinate (a copy, so the whole leaf can be freed);
    leaves with no "model" dimension are shared."""
    m = mesh.shape.get("model", 1)
    r = mesh.coords.get("model", 0)
    out = {}
    for k, t in full.items():
        d = dims[k]
        if d is None or m == 1:
            out[k] = t
        else:
            w = t.shape[d] // m
            out[k] = t.narrow(d, r * w, w).clone()
    return out


def gather_params(local: dict, dims: Mapping, mesh) -> dict:
    """The whole leaves from every "model" rank's slices (a collective:
    every rank of the axis calls it, leaves in sorted order)."""
    from .core.collectives import all_gather
    if mesh.shape.get("model", 1) == 1:
        return dict(local)
    axis = mesh.axis("model")
    out = {}
    for k in sorted(local):
        d, t = dims[k], local[k]
        if d is None:
            out[k] = t
            continue
        g = all_gather(t.contiguous(), axis)
        out[k] = g.movedim(0, d).flatten(d, d + 1).contiguous()
    return out


# -- the decode state (serving) -------------------------------------------------

def state_names(ndim: int) -> tuple:
    """The logical names of a decode-state leaf of ``ndim`` dimensions, as
    the reference's ``_state_spec`` gives them: (layers, batch, kv_seq,
    None, ...) for a cache (L, B, S, ...) or any leaf of 4 or more
    dimensions (rwkv6's wkv (L, B, H, Dh, Dh): its heads; a shift state
    (L, B, 1, D): a length of 1, whole), (layers, batch, None) for 3, none
    below."""
    if ndim >= 4:
        return ("layers", "batch", "kv_seq") + (None,) * (ndim - 3)
    if ndim == 3:
        return ("layers", "batch", None)
    return (None,) * ndim


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict of leaves as one dict of '/'-joined paths."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_tree(v, path + "/"))
        else:
            out[path] = v
    return out


def nest_tree(flat: dict) -> dict:
    """The inverse of ``flat_tree``."""
    out: dict = {}
    for path, t in flat.items():
        *parts, leaf = path.split("/")
        node = out
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def state_specs(state_shapes: Mapping[str, tuple],
                mesh_shape: Mapping[str, int], rules: AxisRules) -> dict:
    """Each decode-state leaf's mesh axes per dimension (``logical_spec``
    of ``state_names``, with the divisibility rule): path -> spec."""
    return {k: logical_spec(state_names(len(shape)), shape, mesh_shape,
                            rules)
            for k, shape in state_shapes.items()}


def local_shape(shape, spec, mesh_shape: Mapping[str, int]) -> tuple:
    """A rank's shape of a leaf of ``shape`` placed by ``spec``."""
    return tuple(n // axis_size(mesh_shape, phys)
                 for n, phys in zip(shape, spec))


def local_slice(shape, spec, mesh) -> tuple:
    """(start, length) per dimension of this rank's block of a leaf of
    ``shape`` placed by ``spec`` on ``mesh`` (a ``GridMesh``: a dimension
    over several axes is split row-major over them)."""
    out = []
    for n, phys in zip(shape, spec):
        if phys is None:
            out.append((0, n))
            continue
        names = phys if isinstance(phys, tuple) else (phys,)
        w = n // mesh.axes_size(names)
        out.append((mesh.axes_index(names) * w, w))
    return tuple(out)
