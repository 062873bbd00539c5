"""The port's launch machinery (``repro_torch.launch.{specs,dryrun,mesh,
train}``) against the reference's ``repro.launch``:

- ``input_specs``: the shapes and dtypes of every assigned arch x input
  shape, as meta tensors;
- ``config_for``: long_500k's sliding-window variant;
- ``build_step`` on a fake (2, 2) process group (smoke Llama-2 at bf16,
  seq_len 32, global batch 4): every argument's placements are those of
  the reference's ``in_shardings``, and one device's argument and output
  bytes are the reference's ``memory_analysis()`` (JAX in a subprocess
  with 4 forced host devices), but for two named terms: the reference's
  Adam step counter is a device int32 (4 bytes in the arguments and in
  the outputs; the port's is a host int) and XLA counts the output
  tuple's index table (8 bytes a leaf) in ``output_size_in_bytes``;
- the dry-run CLI (``--mesh both``) writes its two result files in the
  reference's layout, with ``temp_bytes`` and the collectives null and
  their reason;
- ``launch.train --production`` (and ``--multi-pod``) refuses at world
  size 1, naming the size it found."""
import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro.launch.specs import config_for as j_config_for
from repro.launch.specs import input_specs as j_input_specs
from repro_torch.configs import INPUT_SHAPES as T_SHAPES
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import dryrun
from repro_torch.launch.specs import config_for, input_specs
from repro_torch.models.sharding import P, placements

STEP_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
STEP_COUNTER_BYTES = 4          # the reference's int32 Adam step counter
TUPLE_TABLE_BYTES = 8           # XLA: one pointer per output leaf


def _is_placements(tree):
    from torch.distributed.tensor import Placement

    return isinstance(tree, tuple) and bool(tree) and all(
        isinstance(x, Placement) for x in tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P) \
            and not _is_placements(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_reference(arch, shape):
    want, _ = j_input_specs(get_config(arch), INPUT_SHAPES[shape])
    got, _ = input_specs(t_get_config(arch), T_SHAPES[shape])
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for k, t in _flat(got).items()
           if t.device.type == "meta"}
    assert got == {tuple(k.key for k in path): v for path, v in
                   jax.tree_util.tree_flatten_with_path(
                       want, is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_config_for_long_context():
    for arch in ("deepseek-7b", "llama2-7b"):
        cfg = t_get_config(arch)
        lc = config_for(cfg, T_SHAPES["long_500k"])
        assert lc.window == 4096 == j_config_for(
            get_config(arch), INPUT_SHAPES["long_500k"]).window
        assert config_for(cfg, T_SHAPES["train_4k"]) is cfg


_JAX_STEP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
sys.path.insert(0, "src")
import jax
from repro.configs import INPUT_SHAPES, SMOKE_FACTORIES, get_config
from repro.launch.specs import build_step
cfg = dataclasses.replace(SMOKE_FACTORIES["llama2-7b"](),
                          name=get_config("llama2-7b").name,
                          dtype="bfloat16")
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for name in ("train_4k", "prefill_32k", "decode_32k"):
    shape = dataclasses.replace(INPUT_SHAPES[name], seq_len=32,
                                global_batch=4)
    fn, args, in_sh, donate = build_step(cfg, shape, mesh)
    with mesh:
        c = jax.jit(fn, in_shardings=in_sh,
                    donate_argnums=donate).lower(*args).compile()
    m = c.memory_analysis()
    specs = jax.tree_util.tree_flatten_with_path(in_sh)[0]
    out[name] = {
        "argument_bytes": int(m.argument_size_in_bytes),
        "output_bytes": int(m.output_size_in_bytes),
        "output_leaves": len(jax.tree.leaves(jax.eval_shape(fn, *args))),
        "specs": [[jax.tree_util.keystr(p), list(s.spec)]
                  for p, s in specs]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_steps():
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_STEP)],
                       capture_output=True, text=True, timeout=280)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture
def fake_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


@pytest.mark.parametrize("shape_name", STEP_SHAPES)
def test_build_step_bytes_equal_reference(jax_steps, fake_2x2, shape_name):
    mesh = fake_2x2
    cfg = dataclasses.replace(T_SMOKE["llama2-7b"](),
                              name=t_get_config("llama2-7b").name,
                              dtype="bfloat16")
    shape = dataclasses.replace(T_SHAPES[shape_name], seq_len=32,
                                global_batch=4)
    (fn, args, in_pl, donate), _, flops, arg_bytes, out_bytes = \
        dryrun.step_costs(cfg, shape, mesh)
    want = jax_steps[shape_name]
    train = shape.mode == "train"
    counter = STEP_COUNTER_BYTES if train else 0
    assert arg_bytes + counter == want["argument_bytes"]
    assert out_bytes + counter + TUPLE_TABLE_BYTES * want[
        "output_leaves"] == want["output_bytes"]
    assert donate == ((0, 1) if train else () if shape.mode == "prefill"
                      else (2,))
    assert flops > 0
    # every argument leaf placed as the reference's in_shardings
    got = {_keystr(k): v for k, v in _flat(in_pl).items()}
    assert len(got) == len(want["specs"])
    for path, spec in want["specs"]:
        if path.endswith("['step']"):
            assert got[path] is None            # the host step counter
            continue
        entries = [tuple(e) if isinstance(e, list) else e for e in spec]
        assert got[path] == placements(P(*entries), mesh), path


def test_dryrun_cli_writes_both_meshes(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "llama2-7b", "--shape", "long_500k",
                        "--mesh", "both"]) == 0
    assert not dist.is_initialized()          # each fake group destroyed
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama2-7b__long_500k__multi.json",
                     "llama2-7b__long_500k__single.json"]
    for name, devices in zip(files, (512, 256)):
        res = json.loads((tmp_path / name).read_text())
        assert res["devices"] == devices
        assert set(res) >= {"arch", "shape", "mesh", "devices", "options",
                            "memory", "cost", "collectives"}
        m = res["memory"]
        assert m["argument_bytes"] > 0 and m["output_bytes"] > 0
        assert m["temp_bytes"] is None
        assert "partitioner" in m["temp_bytes_reason"]
        # a decode step's collectives from the port's serving plan
        assert "ServePlan.serve_schedule" in res["collectives"]["schedule"]
        assert res["collectives"]["counts"]["all-reduce"] == \
            1 + 2 * 32                       # the embedding; wo, the MLP
        assert res["cost"]["flops"] * devices == res["cost"]["flops_global"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_refuses_at_world_size_1(multi_pod):
    from repro_torch.launch import train

    assert not dist.is_initialized()
    argv = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
            "--steps", "1", "--production"] + (["--multi-pod"] if multi_pod
                                               else [])
    need = 512 if multi_pod else 256
    with pytest.raises(RuntimeError,
                       match=f"needs a process group of {need} ranks.*"
                             "found world size 1"):
        train.main(argv)
    assert torch.distributed.is_available()
