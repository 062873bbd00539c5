"""Multi-pod dry-run: prove the distribution config is coherent.

Port of ``repro/launch/dryrun.py``, with its CLI and result layout.  For
every (architecture x input shape) pair, build the step on the
production mesh (16 x 16 single-pod and 2 x 16 x 16 multi-pod) over a
fake process group of 256 or 512 ranks in this one process
(``make_production_mesh(fake=True)``: no device, no collective), with
``meta`` stand-ins for every input (nothing allocated), then record:

- ``memory.argument_bytes`` / ``output_bytes``: one device's bytes of the
  step's arguments and outputs, each leaf's local shard under its DTensor
  placements (``compute_local_shape_and_global_offset``): exact;
- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  whole step run on the meta tensors through the kernels' plain versions,
  divided by the number of devices (``flops_global`` keeps the total).

- ``collectives`` of a training shape: one device's bytes (each
  collective's output, the reference's measure) and counts by kind, from
  the port's own schedule, not XLA's: ``train(mesh=...)``'s
  ``models.sharding.ShardPlan`` over meta parameters on the same mesh
  (``ShardPlan.step_schedule``: the gathers at use in the forward and
  again under remat, the gradients' reduce-scatters and replicate-axis
  all-reduces, the loss's and the clip's all-reduces, an MoE layer's
  count of routed tokens, and a channel-parallel RG-LRU layer's
  activation collectives: RecurrentGemma-2B's);
- ``collectives`` of a prefill or decode shape: the same measure from
  the port's serving plan (``models.sharding.ServePlan.serve_schedule``:
  tensor parallelism over ``"model"``, activations moved, no weight
  gathered) for every stack (GQA, MLA, Mamba-2, RG-LRU beside local
  attention, Whisper's encoder-decoder, InternVL2's vision prefix); a
  shape that plan refuses keeps ``null`` with the refusal as the
  reason.

XLA's partitioner is what the reference reads ``temp_bytes`` from; the
port has no counterpart, so it is written as ``null`` with the reason.
A step that needs a value on ``meta`` (``.item()``, a data-dependent
shape) fails with the architecture named.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
Needs no card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \
        --shape train_4k,decode_32k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (build_step, config_for, out_specs,
                                     param_structs, tree_placements)
from repro_torch.models.sharding import (ServePlan, ShardPlan, batch_axes,
                                         mesh_axes, param_specs)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

NO_PARTITIONER = ("no counterpart without XLA's partitioner: the port "
                  "places arguments and outputs; temporaries are chosen "
                  "by no compiler here")
SCHEDULE = ("the port's train(mesh=...) schedule (weights gathered at use: "
            "models.sharding.ShardPlan.step_schedule), not XLA's; bytes "
            "are each collective's output on one device")
SERVE_SCHEDULE = ("the port's serving schedule (tensor parallelism over "
                  "\"model\", activations moved, no weight gathered: "
                  "models.sharding.ServePlan.serve_schedule), not XLA's; "
                  "bytes are each collective's output on one device")


def _pairs(tree, places):
    """(leaf, placements) pairs of matching trees; a host scalar (the
    optimizer's step counter) holds no device bytes."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _pairs(tree[k], places[k])]
    if isinstance(tree, (tuple, list)):
        return [p for t, q in zip(tree, places) for p in _pairs(t, q)]
    return [(tree, places)] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree, places, mesh) -> int:
    """One device's bytes of ``tree`` under ``places`` (mesh coordinate
    0: the first shard, the largest where a split is uneven)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    total = 0
    for leaf, pl in _pairs(tree, places):
        shape, _ = compute_local_shape_and_global_offset(
            tuple(leaf.shape), mesh, pl)
        total += math.prod(shape) * leaf.element_size()
    return total


def step_costs(cfg, shape, mesh):
    """(build_step's result, its outputs, global FLOPs, argument bytes,
    output bytes) of one step on ``mesh``."""
    from torch.utils.flop_counter import FlopCounterMode

    fn, args, in_pl, donate = build_step(cfg, shape, mesh)
    arg_bytes = local_bytes(args, in_pl, mesh)
    counter = FlopCounterMode(display=False)
    with counter:
        outputs = fn(*args)
    out_pl = tree_placements(out_specs(cfg, shape, mesh, outputs), mesh)
    return ((fn, args, in_pl, donate), outputs, counter.get_total_flops(),
            arg_bytes, local_bytes(outputs, out_pl, mesh))


def step_collectives(cfg, shape, mesh):
    """One device's collectives of one ``train(mesh=...)`` step of
    ``shape`` (a training shape) on ``mesh``: {"bytes", "counts"} by
    kind, "total_bytes" and the schedule's label."""
    cfg = config_for(cfg, shape)
    params = param_structs(cfg)
    entry = batch_axes(shape.global_batch, mesh,
                       include_model=cfg.train_batch_over_model)
    plan = ShardPlan(mesh, entry, cfg)
    plan.shard(params, param_specs(params, cfg, mesh))
    out = plan.step_schedule(shape.global_batch * shape.seq_len,
                             grad_clip=True)
    return {**out, "total_bytes": sum(out["bytes"].values()),
            "schedule": SCHEDULE}


def serve_collectives(cfg, shape, mesh):
    """(one device's collectives of one ``prefill`` or ``decode_step`` of
    ``shape`` on ``mesh`` under a ``ServePlan``, as ``step_collectives``
    gives training's, None) or (None, the reason) for a stack the plan
    refuses."""
    cfg = config_for(cfg, shape)
    try:
        plan = ServePlan(mesh, cfg, shape.global_batch)
    except (NotImplementedError, ValueError) as e:
        return None, f"no serving plan: {e}"
    out = plan.serve_schedule(cfg, shape)
    return {**out, "total_bytes": sum(out["bytes"].values()),
            "schedule": SERVE_SCHEDULE}, None


def run_pair(arch: str, shape_name: str, mesh_kind: str, verbose=True,
             fsdp=None, seq_parallel=None, remat_group=None):
    """None options resolve to the production policy: training shapes use
    TP weights + batch over (data x model) + ZeRO-1 optimizer sharding;
    inference shapes use plain TP+DP.  FSDP / sequence-parallel remain
    explicit flags."""
    import torch.distributed as dist

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    over = {"fsdp": bool(fsdp) if fsdp is not None else False,
            "seq_parallel": bool(seq_parallel) if seq_parallel is not None
            else False}
    if remat_group is not None:
        over["remat_group"] = remat_group
    cfg = dataclasses.replace(cfg, **over)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), fake=True)
    try:
        devices = mesh_axes(mesh).size
        t0 = time.time()
        try:
            _, _, flops, arg_bytes, out_bytes = step_costs(cfg, shape, mesh)
            if shape.mode == "train":
                coll, why = step_collectives(cfg, shape, mesh), None
            else:
                coll, why = serve_collectives(cfg, shape, mesh)
        except (RuntimeError, NotImplementedError) as e:
            raise RuntimeError(f"dry-run of {arch} ({shape_name}, "
                               f"{mesh_kind}): the step does not run on "
                               f"meta tensors: {e}") from e
        t_step = time.time() - t0
    finally:
        dist.destroy_process_group()
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "devices": devices,
        "options": {"fsdp": cfg.fsdp, "seq_parallel": cfg.seq_parallel,
                    "remat_group": cfg.remat_group},
        "step_s": round(t_step, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "temp_bytes_reason": NO_PARTITIONER,
            "note": "one device's shard of every argument and output "
                    "under its DTensor placements (exact); the optimizer's "
                    "step counter is a host int",
        },
        "cost": {
            "flops": flops / devices,
            "flops_global": flops,
            "note": "FlopCounterMode over the whole step on meta tensors "
                    "through the kernels' plain versions, divided by the "
                    "number of devices",
        },
        "collectives": coll,
    }
    if coll is None:
        result["collectives_reason"] = why
    if verbose:
        m = result["memory"]
        print(f"{arch:18s} {shape_name:12s} {mesh_kind:6s} "
              f"args={m['argument_bytes'] / 2**30:7.2f}GiB "
              f"out={m['output_bytes'] / 2**30:7.2f}GiB "
              f"flops={result['cost']['flops']:.3e} "
              + (f"coll={coll['total_bytes'] / 2**20:9.1f}MiB " if coll
                 else "") + f"step={t_step:5.1f}s", flush=True)
    return result


def save_result(res: dict):
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help="an input shape, or several joined by commas")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fsdp", type=int, default=None, choices=[0, 1])
    ap.add_argument("--seq-parallel", type=int, default=None, choices=[0, 1])
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--tag", default="", help="suffix for result files")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                fname = os.path.join(OUT_DIR,
                                     f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"skip {arch} {shape} {mesh_kind}", flush=True)
                    continue
                try:
                    res = run_pair(
                        arch, shape, mesh_kind,
                        fsdp=None if args.fsdp is None else bool(args.fsdp),
                        seq_parallel=(None if args.seq_parallel is None
                                      else bool(args.seq_parallel)),
                        remat_group=args.remat_group)
                    if args.tag:
                        res["tag"] = args.tag
                        res["shape"] = f"{shape}@{args.tag}"
                    save_result(res)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"FAIL {arch} {shape} {mesh_kind}: {e}",
                          flush=True)
                    traceback.print_exc()
    print(f"\n{len(failures)} failures")
    for f in failures:
        print("  ", *f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
