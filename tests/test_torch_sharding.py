"""The port's partition specs (``repro_torch.models.sharding``) against the
reference's ``repro.models.sharding``, and their DTensor placements:

- ``param_specs`` on the bridged smoke trees of every assigned arch, leaf
  for leaf as tuples, on the (16, 16) and (2, 16, 16) meshes with
  ``fsdp`` off and on;
- the four full configs of the reference's divisibility test: the port's
  meta tree (``launch.specs.param_structs``) has the shapes and dtypes of
  JAX's ``eval_shape`` tree, the same specs, and every sharded dim
  divides;
- ``cache_specs`` of GQA, MLA, Mamba-2, RG-LRU and Whisper caches;
- the reference's five ``batch_axes`` cases;
- ``placements`` and ``local_shape`` on a fake (16, 16) process group,
  against DTensor's own local shapes;
- the one place the port's shard order differs from JAX's (a dimension
  split over axes out of mesh order), pinned against JAX's
  ``devices_indices_map`` on eight forced host devices."""
import dataclasses
import functools
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS, SMOKE_FACTORIES, get_config
from repro.models import cache_specs as j_cache_specs
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import param_specs as j_param_specs
from repro_torch.configs import ASSIGNED_ARCHS as T_ASSIGNED_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.specs import param_structs
from repro_torch.models import batch_axes, cache_specs, param_specs
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models.sharding import (P, local_shape, placements,
                                         shard_index)
from repro_torch.weights import params_from_numpy

from _torch_train_parity import port_config


class FakeMesh:
    """Lightweight stand-in with .shape/.axis_names (no devices needed),
    the reference test's."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3}


def _flat_specs(tree):
    """{path: tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(k.key for k in path): tuple(s) for path, s in leaves}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _smoke_tree(arch):
    cfg = SMOKE_FACTORIES[arch]()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.key(0), cfg))
    return cfg, params


def test_assigned_archs_copied():
    assert T_ASSIGNED_ARCHS == ASSIGNED_ARCHS


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_reference(arch, mesh, fsdp):
    cfg, params = _smoke_tree(arch)
    cfg = dataclasses.replace(cfg, fsdp=fsdp)
    want = _flat_specs(j_param_specs(params, cfg, MESHES[mesh]))
    got = _flat(param_specs(params_from_numpy(params, "cpu"),
                            port_config(cfg), MESHES[mesh]))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert isinstance(spec, P)
        assert tuple(spec) == want[path], (path, spec, want[path])


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b",
                                  "whisper-large-v3", "mixtral-8x7b"])
def test_full_config_meta_tree_and_specs(arch):
    """The port's meta tree is JAX's eval_shape tree (shapes, dtypes),
    its specs are the reference's, and every sharded dim divides."""
    cfg = get_config(arch)
    structs = jax.eval_shape(lambda: j_init_params(jax.random.key(0), cfg))
    want = _flat(jax.tree.map(lambda s: s, structs,
                              is_leaf=lambda x: hasattr(x, "shape")))
    meta = _flat(param_structs(t_get_config(arch)))
    assert set(meta) == set(want)
    for path, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
    tree = param_structs(t_get_config(arch))
    for fsdp in (False, True):
        jcfg = dataclasses.replace(cfg, fsdp=fsdp)
        jspecs = _flat_specs(j_param_specs(structs, jcfg, MESH))
        specs = _flat(param_specs(tree, dataclasses.replace(
            t_get_config(arch), fsdp=fsdp), MESH))
        assert {k: tuple(v) for k, v in specs.items()} == jspecs
        for path, spec in specs.items():
            shape = meta[path].shape
            for dim, got in zip(shape, local_shape(shape, spec, MESH)):
                assert got * (dim // got) == dim, (path, shape, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["llama2-7b", "minicpm3-4b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "whisper-large-v3"])
def test_cache_specs_equal_reference(arch, mesh):
    """GQA, MLA, Mamba-2, RG-LRU and Whisper's self and cross caches, at
    a batch the data axes divide (32) and one they do not (4)."""
    cfg = SMOKE_FACTORIES[arch]()
    enc = 12 if cfg.is_encoder_decoder else 0
    for batch in (32, 4):
        kw = {"enc_len": enc} if enc else {}
        jcache = j_init_cache(cfg, batch, 16, **kw)
        want = _flat_specs(j_cache_specs(jcache, cfg, MESHES[mesh], batch))
        tcache = t_init_cache(port_config(cfg), batch, 16, device="meta",
                              enc_len=enc)
        got = _flat(cache_specs(tcache, port_config(cfg), MESHES[mesh],
                                batch))
        assert {k: tuple(v) for k, v in got.items()} == want


def test_batch_axes_divisibility():
    assert batch_axes(256, MESH) == "data"
    assert batch_axes(256, MESH3) == ("pod", "data")
    assert batch_axes(1, MESH) is None
    assert batch_axes(8, MESH) is None           # 8 % 16 != 0
    assert batch_axes(256, MESH, include_model=True) == ("data", "model")


@pytest.fixture
def fake_group():
    """A fake process group of 256 ranks in this process (this rank 0),
    destroyed after the test."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(fake=True)
    yield mesh
    torch.distributed.destroy_process_group()


def test_placements_and_local_shape_on_fake_group(fake_group):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = fake_group
    assert placements(P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert placements(P("model", "data"), mesh) == (Shard(1), Shard(0))
    assert placements(P(("data", "model"), None), mesh) == (Shard(0),
                                                           Shard(0))
    assert placements(P(), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="'pod'"):
        placements(P("pod"), mesh)
    cases = [((4096, 11008), P(None, "model")),
             ((32, 4096, 32, 128), P(None, None, "model", None)),
             ((256, 4096), P(("data", "model"), None)),
             ((32000, 4096), P("model", "data")),
             ((49155, 2048), P("model", None)),      # uneven: 3073 rows
             ((7,), P())]
    for shape, spec in cases:
        want, _ = compute_local_shape_and_global_offset(
            shape, mesh, placements(spec, mesh))
        assert local_shape(shape, spec, mesh) == tuple(want), (shape, spec)


_JAX_ORDER = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for name, spec in (("dmp", P(("data", "model", "pod"))),
                   ("pd", P(("pod", "data")))):
    m = NamedSharding(mesh, spec).devices_indices_map((16,))
    out[name] = [[list(map(int, idx)), m[mesh.devices[idx]][0].start]
                 for idx in np.ndindex(mesh.devices.shape)]
print(json.dumps(out))
"""


def test_shard_order_against_jax():
    """Which block of 8 a device at (pod, data, model) holds: the port's
    ``shard_index`` gives JAX's order for every entry; DTensor's mesh
    order (pod outermost) agrees with it where the entry lists its axes
    in mesh order (("pod", "data")) and not for the training batch's
    ("data", "model", "pod") on a multi-pod mesh, where pod is innermost
    in JAX's order."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_ORDER)],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    jax_order = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    names = ("pod", "data", "model")
    for key, entry in (("dmp", ("data", "model", "pod")),
                       ("pd", ("pod", "data"))):
        differs = False
        for coords, start in jax_order[key]:
            c = dict(zip(names, coords))
            index, count = shard_index(entry, mesh, c)
            assert count == (8 if key == "dmp" else 4)
            block = start // (16 // count)
            assert index == block, (key, coords)
            # DTensor nests the same axes in mesh order
            mesh_major = 0
            for n in names:
                if n in entry:
                    mesh_major = mesh_major * 2 + c[n]
            differs |= mesh_major != block
        assert differs == (key == "dmp")
