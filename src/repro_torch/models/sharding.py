"""Partition specs for params / caches / batches, and their placements.

Port of ``repro/models/sharding.py``.  Megatron-style tensor parallelism
over the mesh's ``model`` axis, data parallelism over ``("pod",
"data")``:

- q/o head projections and FFN hidden shard over ``model``;
- KV projections shard only when ``n_kv_heads`` divides the axis
  (GQA with few KV groups replicates KV);
- MoE expert stacks shard over experts when E divides the axis (expert
  parallelism), else over the expert hidden dim (tensor parallelism);
- vocab shards over ``model`` (embedding rows / head columns);
- the batch axis of inputs and caches shards over as many data axes as
  divide it.

A spec is ``P``: a tuple with one entry per leading tensor dimension,
each ``None``, a mesh axis name or a tuple of names, equal entry for
entry to the reference's ``PartitionSpec``.  The functions take any mesh
with ``.shape`` (axis name -> size) and ``.axis_names``; a
``torch.distributed`` ``DeviceMesh`` is read through ``mesh_axes``.

``placements(spec, mesh)`` turns a spec into DTensor placements, one per
mesh dimension (``Shard(dim)`` where the spec names that mesh axis, else
``Replicate()``); ``local_shape`` is a shard's shape.  Per-device bytes
follow from either.  One difference from JAX, pinned by
``tests/test_torch_sharding.py``: a tensor dimension sharded over several
axes is split by DTensor in mesh order (the first mesh dimension
outermost), by JAX in the entry's order.  The two agree whenever the
entry lists its axes in mesh order, which is every spec here but the
training batch's ``("data", "model", "pod")`` on a multi-pod mesh; there
the same rows are spread over the same devices in another order.
``shard_index`` gives JAX's order, and ``train(mesh=...)`` takes its
batch rows by it.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: ``P(None, "model")`` shards a tensor's second
    dimension over the ``model`` axis; trailing dimensions not listed
    are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class _DeviceMeshAxes:
    """``.shape`` / ``.axis_names`` / ``.size`` of a ``DeviceMesh``."""

    def __init__(self, mesh):
        self.device_mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))
        self.size = math.prod(mesh.shape)


def mesh_axes(mesh):
    """``mesh`` itself when it has ``axis_names`` (the tests' fake
    meshes), else a view of a ``DeviceMesh`` with that interface."""
    if hasattr(mesh, "axis_names"):
        return mesh
    return _DeviceMeshAxes(mesh)


def _div(n, size):
    return size > 0 and n % size == 0


def _axis_names(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def batch_axes(batch: int, mesh, include_model: bool = False):
    """Largest prefix-product of data-like axes that divides the batch.

    ``include_model=True`` (training) also spreads the batch over the
    model axis (ZeRO-style: weights are gathered at use, so every axis is
    a batch axis and the per-device token count is minimal)."""
    mesh = mesh_axes(mesh)
    names = [n for n in mesh.axis_names if n in ("pod", "data")]
    if include_model and "model" in mesh.axis_names:
        names = [n for n in ("data", "model", "pod")
                 if n in mesh.axis_names]
    chosen = []
    prod = 1
    for n in names:
        sz = mesh.shape[n]
        if batch % (prod * sz) == 0:
            chosen.append(n)
            prod *= sz
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, cfg: ModelConfig, mesh):
    """Spec tree matching the param tree (stacked-stage layout).

    With ``cfg.fsdp`` the largest still-unsharded weight dim additionally
    shards over the ``data`` axis (ZeRO-3 style: the persistent
    param/grad/optimizer state is 1/data-size per device)."""
    mesh = mesh_axes(mesh)
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1
    dsize = mesh.shape["data"] if "data" in mesh.axis_names else 1
    kv_ok = _div(cfg.n_kv_heads, msize)
    q_ok = _div(cfg.n_heads, msize)
    # head-dim fallback: when the head count doesn't divide the model
    # axis (whisper 20H, GQA kv=8/4/1), shard the head_dim contraction
    hd_ok = _div(cfg.resolved_head_dim(), msize)
    vocab_ok = _div(cfg.vocab_size, msize)
    e_ok = cfg.moe is not None and _div(cfg.moe.n_experts, msize)

    def fsdp_ify(spec, shape, stacked):
        if not cfg.fsdp or dsize <= 1 or len(shape) < 2:
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        # best unsharded dim (skip the stacked-layer dim 0)
        cands = [i for i in range(int(stacked), len(shape))
                 if axes[i] is None and shape[i] % dsize == 0]
        if not cands:
            return spec
        best = max(cands, key=lambda i: shape[i])
        axes[best] = "data"
        return P(*axes)

    def spec(keys, leaf):
        name = keys[-1] if keys else ""
        stacked = "stages" in keys
        r = leaf.ndim
        m = "model"

        def s(*axes):
            """Prepend the stacked-layer None axis when inside a stage."""
            if stacked and r == len(axes) + 1:
                return P(None, *axes)
            if r != len(axes):
                raise ValueError(f"param_specs: {'.'.join(keys)} of shape "
                                 f"{tuple(leaf.shape)} takes {len(axes)} "
                                 "axes")
            return P(*axes)

        if name == "table":
            return P(m if vocab_ok else None, None)
        if name == "head":
            return P(None, m if vocab_ok else None)
        if name == "scale":
            return P(*([None] * r))
        if name in ("w_gate", "w_in", "w_out") and r - int(stacked) == 3:
            # stacked MoE expert weights: (L, E, d, f) / (L, E, f, d)
            if name == "w_out":
                return s(m, None, None) if e_ok else s(None, m, None)
            return s(m, None, None) if e_ok else s(None, None, m)
        if name == "router":
            return s(None, None)
        if name in ("wq", "wk", "wv"):
            ok = q_ok if (name == "wq" or "cross" in keys) else kv_ok
            if ok:
                return s(None, m, None)
            return s(None, None, m) if hd_ok else s(None, None, None)
        if name == "wo":
            if q_ok:
                return s(m, None, None)
            return s(None, m, None) if hd_ok else s(None, None, None)
        if name in ("wq_a", "wkv_a"):
            return s(None, None)
        if name in ("wq_b", "wkv_b"):
            return s(None, m if q_ok else None, None)
        if name in ("w_in", "w_gate", "w_branch_x", "w_branch_gate",
                    "in_proj", "conv_w", "w_gate_a", "w_gate_i"):
            return s(None, m)
        if name in ("w_out", "out_proj"):
            return s(m, None)
        if name == "conv_b":
            return s(m)
        if name in ("A_log", "dt_bias", "D", "lam"):
            nh = leaf.shape[-1]
            return s(m if _div(nh, msize) else None)
        return P(*([None] * r))

    def spec_with_fsdp(keys, leaf):
        base = spec(keys, leaf)
        if keys and keys[-1] == "scale":
            return base                      # norms stay replicated
        return fsdp_ify(base, tuple(leaf.shape), "stages" in keys)

    return _map_with_path(spec_with_fsdp, params)


def cache_specs(cache, cfg: ModelConfig, mesh, batch: int):
    mesh = mesh_axes(mesh)
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1
    b = batch_axes(batch, mesh)
    kv_ok = _div(cfg.n_kv_heads, msize)
    hd_ok = _div(cfg.resolved_head_dim(), msize)

    def spec(keys, leaf):
        name = keys[-1] if keys else ""
        if name == "pos":
            return P()
        if name in ("k", "v"):
            if kv_ok:
                return P(None, b, None, "model", None)
            return P(None, b, None, None, "model" if hd_ok else None)
        if name in ("k_s", "v_s"):
            return P(None, b, None, "model" if kv_ok else None)
        if name == "c":
            r = leaf.shape[-1]
            return P(None, b, None, "model" if _div(r, msize) else None)
        if name == "k_rope":
            return P(None, b, None, None)
        if name in ("cross_k", "cross_v"):
            if _div(cfg.n_heads, msize):
                return P(None, b, None, "model", None)
            return P(None, b, None, None, "model" if hd_ok else None)
        if name == "conv_state":
            ch = leaf.shape[-1]
            return P(None, b, None, "model" if _div(ch, msize) else None)
        if name == "ssm_state":
            nh = leaf.shape[2]
            return P(None, b, "model" if _div(nh, msize) else None, None,
                     None)
        if name == "h":
            d = leaf.shape[-1]
            return P(None, b, "model" if _div(d, msize) else None)
        return P(*([None] * leaf.ndim))

    return _map_with_path(spec, cache)


def batch_specs(batch_tree, mesh, batch: int, include_model: bool = False):
    b = batch_axes(batch, mesh, include_model)

    def spec(_keys, leaf):
        return P(b, *([None] * (leaf.ndim - 1))) if leaf.ndim else P()

    return _map_with_path(spec, batch_tree)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec``: for each mesh dimension in order,
    ``Shard(d)`` when the spec names that axis at tensor dimension ``d``,
    else ``Replicate()``.  A dimension named under several axes is split
    in mesh order (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_axes(mesh)
    where = {}
    for d, entry in enumerate(spec):
        for name in _axis_names(entry):
            if name not in mesh.axis_names or name in where:
                raise ValueError(f"placements: spec {spec} names axis "
                                 f"{name!r} that the mesh "
                                 f"{mesh.axis_names} lacks, or twice")
            where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.axis_names)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec``: each sharded dimension divided by the product of its axes'
    sizes (rounded up, as the first shard holds it)."""
    mesh = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        parts = math.prod(mesh.shape[n] for n in _axis_names(entry))
        out[d] = -(-out[d] // parts)
    return tuple(out)


def shard_index(entry, mesh, coords: dict) -> tuple:
    """(index, count): which of ``count`` equal blocks of a dimension
    sharded by spec entry ``entry`` the device at mesh coordinates
    ``coords`` (axis name -> coordinate) holds, in JAX's order (the
    entry's first axis outermost)."""
    mesh = mesh_axes(mesh)
    index, count = 0, 1
    for name in _axis_names(entry):
        index = index * mesh.shape[name] + coords[name]
        count *= mesh.shape[name]
    return index, count
