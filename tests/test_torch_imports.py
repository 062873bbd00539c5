"""The PyTorch port stands alone: every ``repro_torch`` module imports with
``jax`` and ``repro`` made unimportable, and no module builds a kernel
when it is imported.  Also drives the port's ``serve`` launcher on the
CPU."""
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
             "repro_torch.serving.cluster", "repro_torch.configs.starcoder2_7b"):
    assert name in names, name
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
    """Both backends: Llama-2 on paged pools, Mamba-2 on slots (whole-
    prompt prefill through the SSD scan's plain version)."""
    from repro_torch.launch import serve
    for args in (["--backend", "paged"],
                 ["--backend", "slots", "--arch", "mamba2-2.7b"]):
        serve.main(["--device", "cpu", "--scheduler", "fcfs", "--duration",
                    "1.5", *args])
        out = capsys.readouterr().out
        assert "device=cpu" in out and f"backend={args[1]}" in out
        done, total = out.split("finished ")[1].split(
            " requests")[0].split("/")
        assert done == total and int(total) > 0


def test_serve_launcher_defaults_to_cuda(monkeypatch):
    import torch
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--scheduler", "fcfs", "--duration", "0.5"])
