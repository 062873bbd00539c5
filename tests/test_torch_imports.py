"""The PyTorch port stands alone: every ``repro_torch`` module imports with
``jax`` and ``repro`` made unimportable, and no module builds a kernel
when it is imported.  Also drives the port's ``serve`` and ``train``
launchers on the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.serving.prefix_cache", "repro_torch.core.simulator",
             "repro_torch.serving.cluster", "repro_torch.configs.starcoder2_7b",
             "repro_torch.models.rglru",
             "repro_torch.configs.recurrentgemma_2b",
             "repro_torch.configs.whisper_large_v3",
             "repro_torch.configs.internvl2_76b",
             "repro_torch.training.optim", "repro_torch.training.trainer",
             "repro_torch.training.checkpoint", "repro_torch.training.data",
             "repro_torch.launch.train", "repro_torch.launch.mesh",
             "repro_torch.launch.specs", "repro_torch.launch.dryrun",
             "repro_torch.models.sharding",
             "repro_torch.models.ring_attention"):
    assert name in names, name
# the public entry points the reference's packages export
from repro_torch.models import long_context_variant, loss_fn
from repro_torch.kernels import paged_attention_splitk
from repro_torch.models import batch_axes, batch_specs, cache_specs, param_specs
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
import torch.distributed as dist
assert not dist.is_initialized(), "a process group was started at import"
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
from repro_torch.kernels import _build
assert not _build._loaded, "a kernel library was loaded at import"
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50      # every module was found


def test_serve_launcher_on_cpu(capsys):
    """Both backends: Llama-2 on paged pools, Mamba-2 and
    RecurrentGemma-2B on slots (whole-prompt prefill through the SSD
    scan's and the flash kernel's plain versions)."""
    from repro_torch.launch import serve
    for args in (["--backend", "paged"],
                 ["--backend", "slots", "--arch", "mamba2-2.7b"],
                 ["--backend", "slots", "--arch", "recurrentgemma-2b"]):
        serve.main(["--device", "cpu", "--scheduler", "fcfs", "--duration",
                    "1.5", *args])
        out = capsys.readouterr().out
        assert "device=cpu" in out and f"backend={args[1]}" in out
        done, total = out.split("finished ")[1].split(
            " requests")[0].split("/")
        assert done == total and int(total) > 0


def test_train_launcher_on_cpu(capsys):
    """MiniCPM3-4B's smoke config (MLA) trains through the launcher."""
    from repro_torch.launch import train
    losses = train.main(["--arch", "minicpm3-4b", "--smoke", "--device",
                         "cpu", "--steps", "3", "--batch", "2", "--seq",
                         "32"])
    assert [s for s, _ in losses] == [0, 2]      # every 10th and the last
    assert "final loss:" in capsys.readouterr().out


def test_serve_launcher_defaults_to_cuda(monkeypatch):
    import torch
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--scheduler", "fcfs", "--duration", "0.5"])
