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
batch rows and its parameters' shards by it.

Training on a mesh (``ShardPlan``, the reference's account of model-axis
training: "weights are gathered at use").  Each rank keeps only its shard
of every parameter; a layer gathers its leaves whole just before it uses
them (``GatherAtUse``: an all-gather over each mesh axis that splits the
leaf, innermost first, in ``shard_index``'s order), and the backward
reduce-scatters the whole leaf's gradient back to the shard, a sum over
those axes.  Every layer then sees whole weights; only its rows differ
from rank to rank.  The model reads the plan that ``activate`` sets
(``gather_at_use``, ``layer_gatherer``, ``row_split``,
``channel_split``); with none active every call is the identity, so
serving and ``train()`` run as without a mesh.

The one exception is the recurrent branch of a stack that keeps its batch
off the model axis (``cfg.train_batch_over_model=False``, RecurrentGemma:
the reference's "channel-parallel recurrence", batch over ``data`` x
channels over ``model``).  On a model axis above 1 its RG-LRU leaves
stay this rank's channel block (column shards, ``w_out`` a row shard):
their ``model`` steps are dropped from the gathers (``data`` steps under
fsdp stay), and the branch runs Megatron-style on d_rnn / model channels
(``ChannelSplit``: an all-gather of the conv output's channels before the
gates, which take every channel, and an all-reduce of the output's
partial sums, with the all-reduce of the input's gradient at the branch's
entry).  Such a leaf's gradient is then its block's whole gradient on
every model rank, so ``reduce_grads_`` divides it by the world size over
the model axis's size.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2,
                                      RGLRU, ModelConfig)


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


def shard_block(leaf, spec, mesh, coords, path=()):
    """The block of ``leaf`` (a view) that the device at ``coords`` holds
    under ``spec`` (``shard_index``'s block of each split dimension); a
    dimension that does not split evenly is refused."""
    for d, entry in enumerate(spec):
        index, count = shard_index(entry, mesh, coords)
        if count == 1:
            continue
        if leaf.shape[d] % count:
            raise ValueError(f"{'/'.join(path)} of shape "
                             f"{tuple(leaf.shape)} does not split evenly "
                             f"over {entry} ({count} blocks)")
        n = leaf.shape[d] // count
        leaf = leaf.narrow(d, index * n, n)
    return leaf


# ---------------------------------------------------------------------------
# Training on a mesh: weights gathered at use
# ---------------------------------------------------------------------------
# the reference's collective kinds (``repro/launch/dryrun.py``); the port's
# schedule uses the first three
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def gather_steps(spec, sizes) -> tuple:
    """The (tensor dim, mesh axis) all-gathers that make a leaf of spec
    ``spec`` whole from its shard, in order: the last dimension first and,
    within a dimension split over several axes, the innermost axis first
    (``shard_index``'s order: the entry's first axis outermost).  Axes of
    size 1 gather nothing."""
    return tuple((d, name) for d in reversed(range(len(spec)))
                 for name in reversed(_axis_names(spec[d]))
                 if sizes.get(name, 1) > 1)


def step_bytes(shard_shape, itemsize, steps, sizes):
    """(bytes of each all-gather's output, bytes of each reduce-scatter's
    output) when a shard of ``shard_shape`` is gathered by ``steps`` and
    its gradient scattered back (the reverse order)."""
    shape, gathers = list(shard_shape), []
    for d, name in steps:
        shape[d] *= sizes[name]
        gathers.append(math.prod(shape) * itemsize)
    scatters = []
    for d, name in reversed(steps):
        shape[d] //= sizes[name]
        scatters.append(math.prod(shape) * itemsize)
    return gathers, scatters


class Collectives:
    """The collectives of ``train(mesh=...)`` over a ``DeviceMesh``'s
    axes, each counted by kind (``counts``) and by its output's bytes
    (``bytes``: the gathered tensor, the scattered shard, the reduced
    tensor), the measure of the reference's dry-run.  Native
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` /
    ``all_reduce``: NCCL, and gloo on CPU and CUDA tensors alike."""

    def __init__(self, mesh):
        self.sizes = dict(mesh_axes(mesh).shape)
        self.groups = {n: mesh.get_group(n) for n, size in self.sizes.items()
                       if size > 1}
        self.bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.counts = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def _count(self, kind, t):
        self.bytes[kind] += t.numel() * t.element_size()
        self.counts[kind] += 1

    def all_gather(self, x, dim, axis):
        """``x``'s blocks from every rank of ``axis``, concatenated along
        ``dim`` in the axis' coordinate order."""
        import torch.distributed as dist

        n, x = self.sizes[axis], x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.groups[axis])
        out = out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
            dim, dim + 1)
        self._count("all-gather", out)
        return out

    def reduce_scatter(self, g, dim, axis):
        """This rank's block along ``dim`` of the sum over ``axis`` of
        ``g``."""
        import torch.distributed as dist

        n = self.sizes[axis]
        parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(
            dim, 0).contiguous()
        out = parts.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out, parts.flatten(0, 1),
                                   group=self.groups[axis])
        self._count("reduce-scatter", out)
        return out

    def gather(self, shard, steps):
        for d, name in steps:
            shard = self.all_gather(shard, d, name)
        return shard

    def scatter(self, grad, steps):
        for d, name in reversed(steps):
            grad = self.reduce_scatter(grad, d, name)
        return grad

    def all_reduce_(self, t, axes=None, op="sum"):
        """``t`` summed (``op="max"``: its elementwise maximum) in place
        over each of ``axes`` in turn (None: the whole default group)."""
        import torch.distributed as dist

        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for name in (axes if axes is not None else (None,)):
            dist.all_reduce(t, op=reduce_op, group=None if name is None
                            else self.groups[name])
            self._count("all-reduce", t)
        return t

    def world_all_gather(self, t):
        """(world, *t.shape): every rank's ``t``, by rank."""
        import torch.distributed as dist

        world, t = dist.get_world_size(), t.contiguous()
        out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
        self._count("all-gather", out)
        return out.view((world,) + tuple(t.shape))


class GatherAtUse(torch.autograd.Function):
    """A parameter whole from this rank's shard, by ``steps``'
    all-gathers; the backward reduce-scatters the whole leaf's gradient
    (each rank's, from its own rows) back to the shard: the sum over the
    axes that split the leaf."""

    @staticmethod
    def forward(ctx, shard, steps, comm):
        ctx.steps, ctx.comm = steps, comm
        return comm.gather(shard, steps)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.scatter(grad, ctx.steps), None, None


class RowSplit:
    """Which block of every batch's rows this rank holds (``index`` of
    ``count``, JAX's order over the batch entry's axes) and, for each
    block, the world rank that holds it beside this one (the same
    coordinates on the other axes: ``peers``)."""

    def __init__(self, mesh, entry, coords, comm):
        axes = mesh_axes(mesh)
        self.index, self.count = shard_index(entry, axes, coords)
        self.comm = comm
        batch = set(_axis_names(entry))
        grid = mesh.mesh
        peers = {}
        for pos in itertools.product(*(range(n) for n in grid.shape)):
            at = dict(zip(axes.axis_names, pos))
            if all(at[n] == coords[n] for n in axes.axis_names
                   if n not in batch):
                peers[shard_index(entry, axes, at)[0]] = int(grid[pos])
        self.peers = [peers[i] for i in range(self.count)]

    def gather(self, t):
        """(count, *t.shape): every block's ``t``, in block order."""
        return self.comm.world_all_gather(t)[self.peers]


class WholeBatch:
    """The row split of a batch that one process holds whole: block 0 of
    1, whose gather is the block's own value."""
    index, count = 0, 1

    @staticmethod
    def gather(t):
        return t[None]


WHOLE_BATCH = WholeBatch()


class PlacedLeaf(NamedTuple):
    """One parameter as ``ShardPlan.shard`` placed it: its tree path, this
    rank's shard's shape and element size, the all-gathers that make it
    whole at use (``gather_steps``, less those over ``local``), the mesh
    axes that split it, those (of size above 1) that replicate it, and
    those whose split it keeps at use (the channel-parallel RG-LRU's
    ``model``)."""
    path: tuple
    shape: tuple
    itemsize: int
    steps: tuple
    split: tuple
    replicated: tuple
    local: tuple = ()


def channel_parallel_stages(cfg: ModelConfig, sizes) -> tuple:
    """The stages (``stage_i``) whose RG-LRU branch runs channel-parallel
    over ``model`` (``ChannelSplit``): those of kind RGLRU when the batch
    stays off the model axis (``cfg.train_batch_over_model=False``) and
    that axis is above 1; a model axis that does not divide d_rnn is
    refused."""
    from repro_torch.models.model import model_stages

    m = sizes.get("model", 1)
    if cfg.train_batch_over_model or m <= 1 or cfg.rglru is None:
        return ()
    stages = tuple(f"stage_{i}" for i, (kind, _, _) in
                   enumerate(model_stages(cfg)) if kind == RGLRU)
    d_rnn = cfg.rglru.d_rnn or cfg.d_model
    if stages and d_rnn % m:
        raise ValueError(f"train(mesh=...): the channel-parallel RG-LRU "
                         f"needs d_rnn {d_rnn} to split over the model "
                         f"axis of {m} ranks")
    return stages


class _EnterChannels(torch.autograd.Function):
    """The branch's input: itself forward; backward, the sum over the
    model axis of each rank's partial gradient (from its channels)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        split = ctx.split
        return split.comm.all_reduce_(grad.contiguous().clone(),
                                      (split.axis,)), None


class _LeaveChannels(torch.autograd.Function):
    """The branch's output: the sum over the model axis of each rank's
    partial product (its rows of ``w_out``); backward, itself."""

    @staticmethod
    def forward(ctx, y, split):
        return split.comm.all_reduce_(y.contiguous().clone(), (split.axis,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ChannelSplit:
    """The collectives of a recurrent branch whose channels are split over
    ``axis`` (the plan's ``model``), taken with their group outside any
    ``checkpoint`` (its recompute runs on autograd's thread):

    - ``enter(x)``: the branch's input (identity; the gradient all-reduced);
    - ``gather(u)``: (..., C / size) -> (..., C), every rank's channel
      block in coordinate order (an all-gather; the gradient
      reduce-scattered back);
    - ``leave(y)``: the branch's output summed over the ranks (an
      all-reduce; the gradient passes through)."""

    def __init__(self, comm, axis="model"):
        self.comm, self.axis = comm, axis

    def enter(self, x):
        return _EnterChannels.apply(x, self)

    def gather(self, u):
        return GatherAtUse.apply(u, ((u.ndim - 1, self.axis),), self.comm)

    def leave(self, y):
        return _LeaveChannels.apply(y, self)


class AllChannels:
    """The recurrent branch of a process that holds every channel:
    ``enter``, ``gather`` and ``leave`` return their input."""

    @staticmethod
    def enter(x):
        return x

    @staticmethod
    def gather(u):
        return u

    @staticmethod
    def leave(y):
        return y


ALL_CHANNELS = AllChannels()


class ShardPlan:
    """How ``train(mesh=...)`` splits the parameters over a ``DeviceMesh``
    that spans the default group, and the step's collectives.

    - ``shard`` replaces each leaf by this rank's slice under its
      ``param_specs`` entry (``shard_index``'s block of each split
      dimension; every rank drew the same tree, so nothing is sent) and
      records the leaf's ``gather_steps``;
    - ``gather`` / ``layer_gatherer`` make leaves whole at use
      (``GatherAtUse``);
    - ``reduce_grads_`` sums each gradient over the axes that replicate
      its leaf (the gather's backward summed it over the others) and
      divides by the world size, and ``mean_loss`` averages the loss: the
      step's loss is the mean of the ranks' losses, whether their rows
      are split or replicated;
    - ``global_norm``: the clip's norm of the sharded tree, each leaf's
      sum of squares summed over the axes that split it;
    - ``rows``: the batch rows' split, for statistics over the whole
      batch (the MoE layers');
    - ``channel_split``: for ``cfg``'s ``channel_parallel_stages``, whose
      RG-LRU leaves keep their ``model`` split (module docstring), the
      branch's ``ChannelSplit``, counted on ``comm`` with the rest.

    A mesh axis of size 1 gathers, copies and reduces nothing."""

    def __init__(self, mesh, batch_entry, cfg: ModelConfig):
        axes = mesh_axes(mesh)
        self.cfg = cfg
        self.axes, self.sizes = axes, dict(axes.shape)
        self.world = axes.size
        self.coords = {n: mesh.get_local_rank(n) for n in axes.axis_names}
        self.comm = Collectives(mesh)
        self.rows = RowSplit(mesh, batch_entry, self.coords, self.comm)
        self.channel_stages = channel_parallel_stages(cfg, self.sizes)
        self._channels = ChannelSplit(self.comm)
        self._branches = {}       # id(branch) -> a channel stage's "attn"
        self._steps = {}          # id(shard) -> (shard, gather steps)
        self.leaves = []          # a PlacedLeaf per leaf, in tree order

    def _slice(self, leaf, spec, path):
        return shard_block(leaf, spec, self.axes, self.coords, path)

    def shard(self, params, specs):
        """``params`` with each leaf replaced, in the tree, by this rank's
        shard (a copy where the leaf is split, the leaf itself where not),
        one leaf at a time, so the tree is never held twice."""
        def put(tree, specs, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    put(v, specs[k], path + (k,))
                    continue
                spec = specs[k]
                piece = self._slice(v.detach(), spec, path + (k,))
                if piece.shape != v.shape:
                    piece = piece.clone()
                tree[k] = piece
                del v
                steps = gather_steps(spec, self.sizes)
                named = {n for e in spec for n in _axis_names(e)}
                split = tuple(n for n in self.axes.axis_names
                              if self.sizes[n] > 1 and n in named)
                replicated = tuple(n for n in self.axes.axis_names
                                   if self.sizes[n] > 1 and n not in named)
                local = ()
                if len(path) == 3 and path[0] == "stages" and \
                        path[1] in self.channel_stages and path[2] == "attn":
                    if "model" not in split:
                        raise ValueError(
                            f"train(mesh=...): {'/'.join(path + (k,))} is "
                            "not split over the model axis")
                    local = ("model",)
                    steps = tuple(st for st in steps if st[1] != "model")
                    self._branches[id(tree)] = tree
                self._steps[id(piece)] = (piece, steps)
                self.leaves.append(PlacedLeaf(
                    path + (k,), tuple(piece.shape), piece.element_size(),
                    steps, split, replicated, local))

        put(params, specs, ())
        return params

    def _steps_of(self, leaf):
        got = self._steps.get(id(leaf))
        if got is None or got[0] is not leaf:
            raise KeyError("ShardPlan: a leaf that train(mesh=...) did not "
                           "place")
        return got[1]

    def gather(self, tree):
        """``tree`` (parameters, not stacked) with its split leaves
        gathered at use."""
        if isinstance(tree, dict):
            return {k: self.gather(v) for k, v in tree.items()}
        steps = self._steps_of(tree)
        return GatherAtUse.apply(tree, steps, self.comm) if steps else tree

    def layer_gatherer(self, stage):
        """A function of one layer's tree (``unbind_layers`` of the
        stacked ``stage``) that gathers its split leaves; the stacked
        layer dimension is never split."""
        def shifted(tree):
            if isinstance(tree, dict):
                return {k: shifted(v) for k, v in tree.items()}
            steps = self._steps_of(tree)
            if any(d == 0 for d, _ in steps):
                raise ValueError("ShardPlan: a stacked leaf split over its "
                                 "layer dimension")
            return tuple((d - 1, name) for d, name in steps)

        steps = shifted(stage)

        def gather(tree, steps):
            if isinstance(tree, dict):
                return {k: gather(v, steps[k]) for k, v in tree.items()}
            return GatherAtUse.apply(tree, steps, self.comm) if steps \
                else tree

        return lambda layer: gather(layer, steps)

    def channel_split(self, stage):
        """The ``ChannelSplit`` of the stacked ``stage``'s RG-LRU branch
        when its leaves keep their channel blocks, else ``ALL_CHANNELS``."""
        branch = stage.get("attn")
        if branch is not None and self._branches.get(id(branch)) is branch:
            return self._channels
        return ALL_CHANNELS

    def reduce_grads_(self, grads):
        """The gradients (in tree order), each summed in place over the
        axes that replicate its leaf, then divided by the world size (by
        its quotient by the axes whose split the leaf keeps at use: each of
        their ranks holds its block's whole gradient, where a gathered
        leaf's reduce-scatter summed the ranks' copies)."""
        for g, leaf in zip(grads, self.leaves, strict=True):
            if leaf.replicated:
                self.comm.all_reduce_(g, leaf.replicated)
            div = self.world // math.prod(self.sizes[n] for n in leaf.local)
            if div > 1:
                g.div_(div)

    def mean_loss(self, loss):
        """The mean over the ranks of each rank's loss."""
        if self.world == 1:
            return loss
        return self.comm.all_reduce_(loss.clone()).div_(self.world)

    def global_norm(self, leaves):
        """sqrt of the sum of squares of the whole tree, in f32, from the
        shards ``leaves`` (in tree order): the leaves split over the same
        axes are summed locally, then over those axes."""
        by_axes = {}
        for leaf, placed in zip(leaves, self.leaves, strict=True):
            sq = leaf.float().square().sum()
            key = placed.split
            by_axes[key] = sq if key not in by_axes else by_axes[key] + sq
        total = None
        for key, sq in by_axes.items():
            if key:
                sq = self.comm.all_reduce_(sq, key)
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    def step_schedule(self, n_tokens: int, grad_clip: bool):
        """One device's collectives of one ``train(mesh=...)`` step, from
        this plan (``launch.dryrun``): {"bytes", "counts"} by kind.  Each
        decoder layer's leaves are gathered once in the forward and once
        more under remat, an encoder's once, the embedding table once for
        the inputs and once more for a tied head, the head once; each use
        scatters its gradient back once.  Then the gradients' all-reduces
        over the axes that replicate them, the loss's, the clip's over the
        axes that split leaves, and an MoE layer's count of routed tokens
        per forward (``n_tokens`` of the whole batch reach it), and the
        channel-parallel RG-LRU layers' activation collectives
        (``channel_schedule``)."""
        from repro_torch.models.model import model_stages
        from repro_torch.models.moe import chunk_layout

        cfg = self.cfg
        out = {"bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
               "counts": dict.fromkeys(COLLECTIVE_KINDS, 0)}

        def add(kind, nbytes, times=1):
            out["bytes"][kind] += nbytes * times
            out["counts"][kind] += times

        tied = not any(leaf.path == ("embed", "head")
                       for leaf in self.leaves)
        per_forward = 2 if cfg.remat else 1
        clip_axes = []
        for leaf in self.leaves:
            layers = leaf.shape[0] if "stages" in leaf.path else 1
            if leaf.path[0] == "stages":
                uses, forwards = layers, layers * per_forward
            elif leaf.path == ("embed", "table"):
                uses = forwards = 2 if tied else 1
            else:
                uses = forwards = layers
            gathers, scatters = step_bytes(leaf.shape, leaf.itemsize,
                                           leaf.steps, self.sizes)
            for nbytes in gathers:
                add("all-gather", nbytes // layers, forwards)
            for nbytes in scatters:
                add("reduce-scatter", nbytes // layers, uses)
            for _ in leaf.replicated:
                add("all-reduce", math.prod(leaf.shape) * leaf.itemsize)
            if leaf.split and leaf.split not in clip_axes:
                clip_axes.append(leaf.split)
        if self.world > 1:
            add("all-reduce", 4)                       # the loss
            if grad_clip:
                for key in clip_axes:
                    add("all-reduce", 4, len(key))
        if cfg.moe is not None and self.rows.count > 1:
            n_moe = sum(n for _, moe, n in model_stages(cfg) if moe)
            chunks = 1 if cfg.moe_impl == "dense" else chunk_layout(
                n_tokens)[1]
            add("all-gather", self.world * chunks * cfg.moe.n_experts * 8,
                n_moe * per_forward)
        for key, by_kind in self.channel_schedule(n_tokens).items():
            for kind, v in by_kind.items():
                out[key][kind] += v
        return out

    def channel_schedule(self, n_tokens: int):
        """The channel-parallel RG-LRU layers' share of ``step_schedule``:
        per layer and forward
        (twice under remat), the all-gather of its conv output (this
        rank's rows by d_rnn) and the all-reduce of its output (rows by
        d_model); per backward, the former's reduce-scatter (rows by d_rnn
        / model) and the all-reduce of its input's gradient (rows by
        d_model), in the activations' dtype."""
        from repro_torch.models.layers import dtype_of
        from repro_torch.models.model import model_stages

        cfg = self.cfg
        out = {"bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
               "counts": dict.fromkeys(COLLECTIVE_KINDS, 0)}
        if not self.channel_stages:
            return out

        def add(kind, nbytes, times):
            out["bytes"][kind] += nbytes * times
            out["counts"][kind] += times

        n_rec = sum(n for i, (_, _, n) in enumerate(model_stages(cfg))
                    if f"stage_{i}" in self.channel_stages)
        per_forward = n_rec * (2 if cfg.remat else 1)
        rows = n_tokens // self.rows.count
        item = torch.empty((), dtype=dtype_of(cfg)).element_size()
        d_rnn = cfg.rglru.d_rnn or cfg.d_model
        add("all-gather", rows * d_rnn * item, per_forward)
        add("all-reduce", rows * cfg.d_model * item, per_forward)
        add("reduce-scatter", rows * d_rnn // self.sizes["model"] * item,
            n_rec)
        add("all-reduce", rows * cfg.d_model * item, n_rec)
        return out


# ---------------------------------------------------------------------------
# Serving on a mesh: Megatron-style tensor parallelism, activations moved
# ---------------------------------------------------------------------------
def _refuse(cfg, msize, what):
    raise NotImplementedError(f"{cfg.name}: serving over a model axis of "
                              f"{msize} ranks with {what} is not ported")


def attention_split(cfg: ModelConfig, msize: int) -> str:
    """How ``param_specs`` splits a GQA layer over ``msize`` model ranks:

    - ``"heads"``: q/o over query heads and k/v over kv heads (or no
      model axis: ``msize`` 1);
    - ``"dim"``: every projection over the head dim (the query heads do
      not divide the axis);
    - ``"mixed"``: q/o over query heads, k/v over the head dim (the kv
      heads do not divide the axis).

    A layout that leaves k/v whole on every rank beside split query heads
    (a head dim that does not divide the axis either) is refused."""
    if msize <= 1:
        return "heads"
    q_ok, kv_ok = _div(cfg.n_heads, msize), _div(cfg.n_kv_heads, msize)
    hd_ok = _div(cfg.resolved_head_dim(), msize)
    if q_ok and kv_ok:
        return "heads"
    if hd_ok:
        return "mixed" if q_ok else "dim"
    _refuse(cfg, msize, f"{cfg.n_heads} query heads, {cfg.n_kv_heads} kv "
            f"heads and head dim {cfg.resolved_head_dim()} (k/v replicated "
            "beside split query heads)")


def mla_split(cfg: ModelConfig, msize: int) -> str:
    """How ``param_specs`` splits a multi-head latent attention layer over
    ``msize`` model ranks (``wq_a``, ``wkv_a`` and the norms whole; the
    ``c`` cache over the latent rank r, ``k_rope`` whole):

    - ``"heads"``: ``wq_b``, ``wkv_b`` and ``wo`` over heads (or no model
      axis);
    - ``"dim"``: ``wq_b`` and ``wkv_b`` whole, ``wo`` over ``v_head_dim``
      (the heads do not divide the axis).

    Refused: a latent rank that does not divide the axis (``c`` whole on
    every rank), and heads that do not divide it beside a head dim or
    ``v_head_dim`` that does not either (``wo`` whole or split
    unevenly)."""
    if msize <= 1:
        return "heads"
    m = cfg.mla
    if not _div(m.kv_lora_rank, msize):
        _refuse(cfg, msize, f"latent rank {m.kv_lora_rank} (the c cache "
                "whole on every rank)")
    if _div(cfg.n_heads, msize):
        return "heads"
    if _div(cfg.resolved_head_dim(), msize) and _div(m.v_head_dim, msize):
        return "dim"
    _refuse(cfg, msize, f"{cfg.n_heads} latent-attention heads, head dim "
            f"{cfg.resolved_head_dim()} and v_head_dim {m.v_head_dim} (wo "
            "whole or split unevenly)")


def _group_block(n, n_heads, n_groups, r):
    """[lo, hi) of the groups (of ``n_heads // n_groups`` heads each) that
    the ``n`` heads of rank ``r`` fall in: whole groups, or one group
    holding them all; None when the heads straddle groups."""
    G, a = n_heads // n_groups, r * n
    if n % G == 0:
        return a // G, (a + n) // G
    if G % n == 0:
        return a // G, a // G + 1
    return None


def mamba2_split(cfg: ModelConfig, msize: int) -> str:
    """How ``param_specs`` splits a Mamba-2 layer over ``msize`` model
    ranks: ``"heads"``.  ``in_proj`` (z, x, B, C and dt packed), ``conv_w``
    and ``conv_b`` are column blocks, which are not head-aligned;
    ``A_log``, ``dt_bias``, ``D`` and ``ssm_state`` over heads, ``out_proj``
    over its rows (those heads' channels), ``conv_state`` over channels,
    the norm's ``scale`` whole.  Refused: heads, ``in_proj``'s columns or
    the conv's channels that the axis does not divide (replicated or split
    unevenly), and a rank's heads that straddle their B/C groups."""
    if msize <= 1:
        return "heads"
    from repro_torch.models.ssm import mamba2_dims, proj_width

    s = cfg.ssm
    _, nh, conv_dim = mamba2_dims(cfg)
    width = proj_width(cfg)
    if not (_div(nh, msize) and _div(width, msize) and _div(conv_dim,
                                                            msize)):
        _refuse(cfg, msize, f"{nh} Mamba-2 heads, in_proj width {width} and "
                f"conv width {conv_dim} (replicated or split unevenly)")
    if _group_block(nh // msize, nh, s.n_groups, 0) is None:
        _refuse(cfg, msize, f"{nh // msize} Mamba-2 heads a rank across "
                f"{s.n_groups} B/C groups")
    return "heads"


def rglru_split(cfg: ModelConfig, msize: int) -> str:
    """How ``param_specs`` splits an RG-LRU branch over ``msize`` model
    ranks: ``"channels"``, training's ``ChannelSplit`` (every leaf and the
    ``h`` and ``conv_state`` caches this rank's block of d_rnn, ``w_out``
    its rows).  Refused: a d_rnn that the axis does not divide."""
    d_rnn = cfg.rglru.d_rnn or cfg.d_model
    if msize > 1 and not _div(d_rnn, msize):
        _refuse(cfg, msize, f"RG-LRU width {d_rnn} (replicated)")
    return "channels"


def cross_split(cfg: ModelConfig, msize: int) -> str:
    """How ``param_specs`` splits an encoder-decoder's cross-attention
    (one kv head per query head: ``wq``/``wk``/``wv``/``wo`` and the
    ``cross_k``/``cross_v`` caches alike) over ``msize`` model ranks:
    ``"heads"`` where the heads divide the axis (or no model axis), else
    ``"dim"``, over the head dim.  Refused: a head dim that does not
    divide it either (every cross leaf replicated)."""
    if msize <= 1 or _div(cfg.n_heads, msize):
        return "heads"
    if _div(cfg.resolved_head_dim(), msize):
        return "dim"
    _refuse(cfg, msize, f"{cfg.n_heads} cross-attention heads and head dim "
            f"{cfg.resolved_head_dim()} (replicated)")


def serve_layouts(cfg: ModelConfig, msize: int) -> dict:
    """{layer kind: its layout} of every kind of ``cfg``'s stack
    (``attention_split``, ``mla_split``, ``mamba2_split``,
    ``rglru_split``); a shape that a kind's layout does not take is
    refused by name."""
    split = {ATTN: attention_split, ATTN_LOCAL: attention_split,
             ATTN_MLA: mla_split, MAMBA2: mamba2_split, RGLRU: rglru_split}
    return {kind: split[kind](cfg, msize)
            for kind in sorted(set(cfg.layer_kinds()))}


class ServePlan:
    """Serving (``models.prefill``, ``prefill_chunk``, ``decode_step``) over
    a ``DeviceMesh`` that spans the default group: Megatron-style tensor
    parallelism over ``"model"``, the batch's rows over the data axes that
    divide ``batch`` (the reference's "plain TP+DP" for inference shapes).

    Each rank holds exactly its shard of every parameter under
    ``param_specs`` and of every cache leaf under ``cache_specs``
    (``shard``; ``models.init_cache`` under the plan makes this rank's
    cache shapes); the model moves activations only, counted on ``comm``:

    - the embedding: a masked lookup into this rank's vocab rows, then an
      all-reduce over ``"model"``; the logits are this rank's vocab block
      (``whole_logits`` gathers whole rows, outside any step);
    - attention (``attention_split``): ``"heads"`` runs the layer on this
      rank's query and kv heads (flash in prefill, the paged kernels in
      decode and chunks), then the row-parallel ``wo`` and an all-reduce;
      ``"dim"`` and ``"mixed"`` all-gather the head-dim slices into whole
      heads for the rotary embedding and flash and keep this rank's slice
      for the cache; decode and chunks form partial scores over the
      cache's head-dim slice, all-reduced before the softmax (a plain
      route, ``attention.split_dim_attention``); int8 caches' scales come
      from the absmax all-reduced (max) over the slices;
    - multi-head latent attention (``mla_split``): every rank computes
      ``c`` and ``k_rope`` whole and keeps its slice of ``c``'s latent rank
      for the cache; prefill runs flash on this rank's heads (``"heads"``)
      or on every head (``"dim"``, ``wo`` over ``v_head_dim``); the
      absorbed decode sums every head's partial scores over the cache's
      ``r`` slice (all-reduced, f32, before the softmax; ``"heads"``
      gathers the query heads first), and all-gathers the latent context
      along ``r``;
    - Mamba-2 (``mamba2_split``): the packed projection's column blocks
      all-gathered, the depthwise conv on this rank's channel block (its
      ``conv_state``) and its output all-gathered, the SSD scan on this
      rank's heads (its ``ssm_state``; B and C those heads' groups), the
      gated norm's sum of squares all-reduced (f32), ``out_proj``'s rows
      and an all-reduce of their f32 partial products;
    - RG-LRU (``rglru_split``): training's ``ChannelSplit`` on ``comm``
      (``channel_split``): the branch on d_rnn / m channels (its ``h`` and
      ``conv_state``), the conv output all-gathered for the gates, the
      output all-reduced;
    - the dense FFN and shared experts column- then row-parallel, the MoE
      routed experts over ``"model"`` when E divides it (every rank routes
      every token, the same capacity rule, and combines its experts'
      share), else over the expert hidden dim; the partial sums stay f32
      until one all-reduce and one rounding;
    - an encoder-decoder (Whisper): the encoder's layers split as the
      decoder's attention and FFN layers, over this rank's rows of the
      frames (prefill only); the cross-attention (``cross_layout``,
      ``cross_split``) over this rank's heads, or over the head dim:
      prefill gathers q's, k's and v's slices into whole heads for flash
      and keeps this rank's slice of the output for ``wo``'s rows, decode
      sums the partial scores over the cross caches' head-dim slice (f32,
      before the softmax); ``cross_k``/``cross_v`` are this rank's shards
      from the projections on, never gathered; then ``wo``'s all-reduce;
    - a vision prefix (InternVL2): this rank's rows of the patches go
      ahead of the tokens' vocab-split embedding, whose all-reduce covers
      the tokens only; every later layer sees every position;
    - the batch's rows: ``rows`` (``RowSplit``), which an MoE dispatch's
      capacity and queues span; ``cache["pos"]`` stays whole (its spec is
      ``P()``), each rank reading its rows' positions.

    ``serve_schedule`` derives one step's collectives from the config and
    the mesh, kind for kind (the dry-run's serving ``collectives``).  A
    shape that a layer kind's layout does not take is refused by name
    (``serve_layouts``, ``cross_split``).  The hooks of training's plan
    gather nothing here: no weight is gathered."""

    def __init__(self, mesh, cfg: ModelConfig, batch: int):
        from repro_torch.models.model import check_ported

        if cfg.fsdp:
            raise ValueError(f"{cfg.name}: ServePlan serves with no weight "
                             "gathered; cfg.fsdp splits weights over "
                             "\"data\"")
        axes = mesh_axes(mesh)
        self.mesh, self.cfg, self.batch = mesh, cfg, batch
        self.axes, self.sizes = axes, dict(axes.shape)
        self.m = self.sizes.get("model", 1)
        check_ported(cfg)
        self.layouts = serve_layouts(cfg, self.m)
        self.cross_layout = cross_split(cfg, self.m) \
            if cfg.is_encoder_decoder else None
        # the stack's attention layout (GQA or MLA; "heads" without one)
        self.layout = next((v for k, v in self.layouts.items()
                            if v != "channels"), "heads")
        self.coords = {n: mesh.get_local_rank(n) for n in axes.axis_names}
        self.r = self.coords.get("model", 0)
        self.comm = Collectives(mesh)
        rows = RowSplit(mesh, batch_axes(batch, axes), self.coords,
                        self.comm)
        self.rows = rows if rows.count > 1 else WHOLE_BATCH
        self._channels = ChannelSplit(self.comm)
        self.vocab_split = self.m > 1 and _div(cfg.vocab_size, self.m)
        self.expert_split = cfg.moe is not None and _div(cfg.moe.n_experts,
                                                         self.m)

    # -- placement ----------------------------------------------------------
    def shard(self, tree, specs, path=()):
        """``tree`` with each leaf replaced in place by this rank's block
        under ``specs`` (a copy where split, the leaf itself where not; one
        leaf at a time, so the whole tree is never held twice)."""
        for k, v in tree.items():
            if isinstance(v, dict):
                self.shard(v, specs[k], path + (k,))
                continue
            piece = shard_block(v, specs[k], self.axes, self.coords,
                                path + (k,))
            tree[k] = piece.clone() if piece.shape != v.shape else v
            del v, piece
        return tree

    def shard_params(self, params):
        """``shard`` under ``param_specs``."""
        return self.shard(params, param_specs(params, self.cfg, self.mesh))

    def rows_of(self, t):
        """This rank's block of the batch's rows of ``t`` (dim 0)."""
        n = t.shape[0] // self.rows.count
        return t.narrow(0, self.rows.index * n, n)

    def whole_logits(self, logits):
        """Whole vocab rows from this rank's block: an all-gather over
        ``"model"``, outside any step, so on a ``Collectives`` of its own
        (not counted on ``comm``)."""
        if not self.vocab_split:
            return logits
        return Collectives(self.mesh).all_gather(logits, logits.ndim - 1,
                                                 "model")

    # -- the model's collectives ------------------------------------------
    def reduce(self, t):
        """``t`` summed over ``"model"`` (in place when contiguous)."""
        if self.m == 1:
            return t
        return self.comm.all_reduce_(t.contiguous(), ("model",))

    def reduce_max(self, t):
        """``t``'s elementwise maximum over ``"model"``."""
        if self.m == 1:
            return t
        return self.comm.all_reduce_(t.contiguous(), ("model",), op="max")

    def gather_model(self, t, dim):
        """Every model rank's block of ``t`` along ``dim``, in order."""
        if self.m == 1:
            return t
        return self.comm.all_gather(t, dim % t.ndim, "model")

    @property
    def splits_dims(self) -> bool:
        """Whether k/v (and the caches) split their head dim."""
        return self.layout in ("dim", "mixed")

    def dim_slice(self, t):
        """This rank's block of ``t``'s last dim (a head dim)."""
        n = t.shape[-1] // self.m
        return t[..., self.r * n:(self.r + 1) * n]

    def local_heads(self, t, dim=2):
        """This rank's block of ``t``'s heads along ``dim`` (query heads of
        (B, T, Hq, ...) by default)."""
        n = t.shape[dim] // self.m
        return t.narrow(dim, self.r * n, n)

    def groups_for_local_heads(self, t, n_heads):
        """The groups of ``t`` (..., G, N) that this rank's block of
        ``n_heads`` heads use (GQA's kv heads under ``"mixed"``, Mamba-2's
        B/C groups), contiguous."""
        n = n_heads // self.m
        block = _group_block(n, n_heads, t.shape[-2], self.r)
        if block is None:
            raise NotImplementedError(
                f"{self.cfg.name}: {n} heads a rank do not map onto whole "
                f"groups of {n_heads // t.shape[-2]}")
        return t[..., block[0]:block[1], :].contiguous()

    def kv_for_local_heads(self, t):
        """The kv heads of ``t`` (B, S, Hkv, D) that this rank's query
        heads (the ``"mixed"`` layout) attend, contiguous."""
        return self.groups_for_local_heads(t, self.cfg.n_heads)

    def experts_held(self, n_experts):
        """(first, count) of the routed experts whose weights this rank
        holds: E / m of them under expert parallelism, else all (their
        hidden dim split)."""
        if self.expert_split:
            n = n_experts // self.m
            return self.r * n, n
        return 0, n_experts

    # -- the hooks of training's plan: the identity ------------------------
    def gather(self, tree):
        return tree

    def layer_gatherer(self, stage):
        return _same

    def channel_split(self, stage):
        """The ``ChannelSplit`` on ``comm`` of a stacked RG-LRU stage (its
        branch holds ``lam``) on a model axis above 1, else
        ``ALL_CHANNELS``."""
        branch = stage.get("attn")
        if self.m > 1 and isinstance(branch, dict) and "lam" in branch:
            return self._channels
        return ALL_CHANNELS

    # -- the schedule -------------------------------------------------------
    def serve_schedule(self, cfg: ModelConfig, shape, cache_len=None):
        """One device's collectives of one serving step of ``shape`` on
        this plan's mesh: {"bytes", "counts"} by kind, bytes of each
        collective's output, as ``Collectives`` counts them.  ``shape``'s
        mode: ``"prefill"`` (``seq_len`` tokens a row into caches of
        ``cache_len``, ``prefill``'s ``max_len``), ``"decode"`` (one token a
        row over caches of ``cache_len``) or ``"chunk"`` (``prefill_chunk``
        of ``seq_len`` tokens a row into caches of ``cache_len``);
        ``cache_len`` defaults to ``seq_len``.  Per layer on a model axis
        above 1, kind for kind (``ServePlan``'s account of each): the
        attention's or the branch's own collectives, then the all-reduce
        of its output projection's partial sums, an encoder-decoder's
        cross-attention terms and its ``wo``'s all-reduce, and, but on
        Mamba-2 layers, the FFN's.  The embedding's all-reduce covers the
        tokens (a vision prefix's ``n_frontend_tokens`` patches of a
        prefill's ``seq_len`` positions are not embedded); an
        encoder-decoder's prefill runs ``n_encoder_layers`` attention and
        FFN layers over ``n_frontend_tokens`` frames first, the length of
        the cross caches in every mode."""
        from repro_torch.models.layers import dtype_of
        from repro_torch.models.model import _cache_seq_len, model_stages
        from repro_torch.models.moe import chunk_layout

        out = {"bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
               "counts": dict.fromkeys(COLLECTIVE_KINDS, 0)}

        def add(kind, nbytes, times=1):
            out["bytes"][kind] += nbytes * times
            out["counts"][kind] += times

        m = self.m
        entry = batch_axes(shape.global_batch, self.axes)
        count = shard_index(entry, self.axes, self.coords)[1]
        rows = shape.global_batch // count
        T = 1 if shape.mode == "decode" else shape.seq_len
        cache_len = cache_len or shape.seq_len
        item = torch.empty((), dtype=dtype_of(cfg)).element_size()
        act = rows * T * cfg.d_model * item
        layouts = serve_layouts(cfg, m)
        prefix = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" \
            and shape.mode == "prefill" else 0
        if m > 1 and _div(cfg.vocab_size, m):               # the embedding
            add("all-reduce", rows * (T - prefix) * cfg.d_model * item)
        T_enc = cfg.n_frontend_tokens
        if cfg.is_encoder_decoder and shape.mode == "prefill" and m > 1:
            n = cfg.n_encoder_layers                        # the encoder
            for coll, nbytes, times in _attention_terms(
                    dataclasses.replace(cfg, kv_quant=False),
                    attention_split(cfg, m), "prefill", rows, T_enc, T_enc,
                    item, n):
                add(coll, nbytes, times)
            add("all-reduce", rows * T_enc * cfg.d_model * item, 2 * n)
        for kind, moe, n in model_stages(cfg):
            if m > 1:
                S_c = _cache_seq_len(cfg, kind, cache_len)
                for coll, nbytes, times in _SERVE_TERMS[kind](
                        cfg, layouts[kind], shape.mode, rows, T, S_c, item, n):
                    add(coll, nbytes, times)
                # the output's partial sums: f32 for a Mamba-2 layer
                add("all-reduce", rows * T * cfg.d_model * 4
                    if kind == MAMBA2 else act, n)
                if cfg.is_encoder_decoder:
                    for coll, nbytes, times in _cross_terms(
                            cfg, cross_split(cfg, m), shape.mode, rows, T,
                            T_enc, item, n):
                        add(coll, nbytes, times)
                    add("all-reduce", act, n)               # the cross wo
                if kind in _FFN_KINDS:    # the FFN's: f32 for an MoE layer
                    add("all-reduce", rows * T * cfg.d_model * 4 if moe
                        else act, n)
            if moe and cfg.moe_impl == "dispatch" and count > 1:
                nc = chunk_layout(rows * T * count)[1]
                add("all-gather", self.axes.size * nc * cfg.moe.n_experts
                    * 8, n)
        return out


# a stage's collectives on a model axis above 1 before its layers'
# output all-reduces, by kind: (cfg, layout, mode, rows, T, cache slots,
# item, layers) -> [(collective, bytes of its output, calls)]
def _attention_terms(cfg, layout, mode, rows, T, S_c, item, n):
    """GQA: over a head-dim split, k's slices gathered (and v's in
    prefill), q's (``"dim"``, or outside prefill), the partial scores
    all-reduced outside prefill (and an int8 cache's v absmax), every
    head's output gathered (``"mixed"`` outside prefill); in prefill an
    int8 cache's absmax of the stage's k and of its v, once each."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    if layout == "heads":
        return []
    kv = rows * T * Hkv * D * item
    terms = [("all-gather", kv, n)]                                # k
    if mode == "prefill":
        terms.append(("all-gather", kv, n))                        # v
    if layout == "dim" or mode != "prefill":
        terms.append(("all-gather", rows * T * Hq * D * item, n))  # q
    if mode != "prefill":
        terms.append(("all-reduce", rows * Hq * T * S_c * 4, n))
        if cfg.kv_quant:
            terms.append(("all-reduce", rows * T * Hkv * 4, n))
        if layout == "mixed":
            terms.append(("all-gather", rows * T * Hq * D * item, n))
    elif cfg.kv_quant:
        terms.append(("all-reduce", n * rows * S_c * Hkv * 4, 2))
    return terms


def _cross_terms(cfg, layout, mode, rows, T, T_enc, item, n):
    """An encoder-decoder's cross-attention over the head dim: in prefill
    q's slices gathered and the encoder's k's and v's (``T_enc`` frames),
    in decode the partial scores all-reduced (f32); over heads nothing
    before its ``wo``'s all-reduce."""
    if layout == "heads":
        return []
    H, D = cfg.n_heads, cfg.resolved_head_dim()
    if mode == "prefill":
        return [("all-gather", rows * T * H * D * item, n),
                ("all-gather", rows * T_enc * H * D * item, 2 * n)]
    return [("all-reduce", rows * H * T * T_enc * 4, n)]


def _mla_terms(cfg, layout, mode, rows, T, S_c, item, n):
    """MLA decode: the query heads' latent and rotary parts gathered
    (``"heads"``), the partial scores all-reduced (f32), the latent
    context gathered along r; prefill moves nothing here."""
    if mode == "prefill":
        return []
    H, r = cfg.n_heads, cfg.mla.kv_lora_rank
    terms = []
    if layout == "heads":
        terms.append(("all-gather", rows * T * H * (
            r + cfg.mla.qk_rope_head_dim) * item, n))
    return terms + [("all-reduce", rows * H * T * S_c * 4, n),
                    ("all-gather", rows * T * H * r * item, n)]


def _mamba2_terms(cfg, layout, mode, rows, T, S_c, item, n):
    """Mamba-2: the projection's and the conv output's column blocks
    gathered, the gated norm's sum of squares all-reduced (f32)."""
    from repro_torch.models.ssm import mamba2_dims, proj_width

    conv_dim = mamba2_dims(cfg)[2]
    return [("all-gather", rows * T * proj_width(cfg) * item, n),
            ("all-gather", rows * T * conv_dim * item, n),
            ("all-reduce", rows * T * 4, n)]


def _rglru_terms(cfg, layout, mode, rows, T, S_c, item, n):
    """RG-LRU: the conv output's channels gathered for the gates."""
    return [("all-gather", rows * T * (cfg.rglru.d_rnn or cfg.d_model)
             * item, n)]


_SERVE_TERMS = {ATTN: _attention_terms, ATTN_LOCAL: _attention_terms,
                ATTN_MLA: _mla_terms, MAMBA2: _mamba2_terms,
                RGLRU: _rglru_terms}
_FFN_KINDS = (ATTN, ATTN_LOCAL, ATTN_MLA, RGLRU)


@torch.no_grad()
def gather_tree(shards, specs, mesh):
    """A new tree of whole leaves from this rank's ``shards`` of a tree
    placed by ``specs`` (``ShardPlan.shard``'s cut); every rank of the
    mesh calls it.  The checkpoint of ``train(mesh=...)`` and the tests
    read whole trees by it."""
    comm = Collectives(mesh)

    def walk(tree, specs):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k]) for k, v in tree.items()}
        return comm.gather(tree, gather_steps(specs, comm.sizes))

    return walk(shards, specs)


_ACTIVE = contextvars.ContextVar("repro_torch_shard_plan", default=None)


@contextlib.contextmanager
def activate(plan):
    """``plan`` (a ``ShardPlan`` or a ``ServePlan``, or None) is the one
    the model reads until the block ends."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def gather_at_use(tree):
    """``tree`` (parameters, not stacked) whole, by the active plan's
    gathers; ``tree`` itself with no plan active."""
    plan = _ACTIVE.get()
    return tree if plan is None else plan.gather(tree)


def _same(tree):
    return tree


def layer_gatherer(stage):
    """A function that makes one layer's tree (of the stacked ``stage``)
    whole; the identity with no plan active."""
    plan = _ACTIVE.get()
    return _same if plan is None else plan.layer_gatherer(stage)


def channel_split(stage):
    """The active plan's ``ChannelSplit`` for the stacked ``stage`` when
    its RG-LRU branch runs channel-parallel, else ``ALL_CHANNELS`` (and
    with no plan active)."""
    plan = _ACTIVE.get()
    return ALL_CHANNELS if plan is None else plan.channel_split(stage)


def row_split():
    """The active plan's ``RowSplit`` where the batch's rows are split
    over several ranks, else ``WHOLE_BATCH``."""
    plan = _ACTIVE.get()
    if plan is None or plan.rows.count == 1:
        return WHOLE_BATCH
    return plan.rows


def serving():
    """The active ``ServePlan``, or None (no plan, or training's)."""
    plan = _ACTIVE.get()
    return plan if isinstance(plan, ServePlan) else None


def model_split():
    """The active ``ServePlan`` when its model axis is above 1, else None:
    what the layers take as ``tp``."""
    plan = serving()
    return plan if plan is not None and plan.m > 1 else None
