"""The port's engine examples (``examples/quickstart_torch.py``,
``examples/serve_multiarch_torch.py``) run on the CPU through their
``main()``, with ``jax`` and ``repro`` made unimportable: they stand on
the port alone."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_RUN = """
import importlib.util, json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
result = mod.main(["--device", "cpu"])
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("RESULT " + json.dumps(result))
"""


def run_example(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN,
                          str(ROOT / "examples" / f"{name}.py")], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout, json.loads(out.stdout.split("RESULT ")[-1])


def test_quickstart_serves_two_clients_under_equinox():
    text, result = run_example("quickstart_torch")
    assert result["requests"] == 12 and result["iterations"] > 0
    assert set(result["service"]) == {"alice", "bob"}
    assert 0.5 < result["jain"] <= 1.0
    assert "uncalibrated" in text and "modeled" in text


def test_serve_multiarch_serves_every_decoder_only_arch():
    from repro_torch.configs import SMOKE_FACTORIES

    text, served = run_example("serve_multiarch_torch")
    assert sorted(served) == sorted(SMOKE_FACTORIES)
    assert served.pop("whisper-large-v3") is None
    assert "decoder-only" in text           # the engine's reason, printed
    for arch, (ok, n) in served.items():
        assert ok == n == 6, arch


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "serve_multiarch_torch"])
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for ``cuda`` (as
    ``train_100m_torch.py``) and, with no card, refuses rather than move
    to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
