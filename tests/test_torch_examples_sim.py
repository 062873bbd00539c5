"""The port's simulator examples (``examples/cluster_serving_torch.py``,
``examples/fairness_comparison_torch.py``) against the reference's
(``examples/cluster_serving.py``, ``examples/fairness_comparison.py``).

Both port examples run in one subprocess through their ``main()``, with
``jax`` and ``repro`` made unimportable: they stand on the port alone.
Meanwhile the reference's examples run here, their printout captured.
The simulator, the cluster and the cost model are copies, so the tables
are equal line for line: the cluster's three policy rows, and the
fairness table's FCFS and VTC rows at ``--scenario balanced --duration
8``.  The Equinox row depends on MoPE's trained experts, which the two
frameworks train to different weights; run through the port's
``fairness_rows`` with the reference example's own experts carried over
by the weight bridge (as ``tests/test_torch_predictor.py`` does), it
equals the reference's too."""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAIRNESS_ARGS = ["--scenario", "balanced", "--duration", "8"]

_RUN = """
import importlib.util, json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None

def load(path):
    spec = importlib.util.spec_from_file_location("example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

tables = {"cluster": load(sys.argv[1]).main([]),
          "fairness": load(sys.argv[2]).main(json.loads(sys.argv[3]))}
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("RESULT " + json.dumps(tables))
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def examples():
    """(the port's printout and tables, the reference's printed lines of
    each example, the MoPE the reference's fairness example trained)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN,
         str(ROOT / "examples" / "cluster_serving_torch.py"),
         str(ROOT / "examples" / "fairness_comparison_torch.py"),
         json.dumps(FAIRNESS_ARGS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ref = {"cluster": _printed(_load("cluster_serving").main)}
        fair = _load("fairness_comparison")
        made, MoPE = [], fair.MoPE

        def recorded(*args, **kw):
            made.append(MoPE(*args, **kw))
            return made[-1]

        fair.MoPE = recorded
        argv = sys.argv
        sys.argv = ["fairness_comparison.py", *FAIRNESS_ARGS]
        try:
            ref["fairness"] = _printed(fair.main)
        finally:
            sys.argv = argv
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    return out, json.loads(out.split("RESULT ")[-1]), ref, made[0]


def test_cluster_rows_equal_reference(examples):
    text, tables, ref, _ = examples
    rows = [r["line"] for r in tables["cluster"]]
    assert [r["policy"] for r in tables["cluster"]] == ["round_robin",
                                                        "least_kv",
                                                        "min_ttft"]
    assert rows == [line for line in ref["cluster"]
                    if line.startswith("policy=")]
    assert text.splitlines()[:len(ref["cluster"])] == ref["cluster"]


def test_fairness_baseline_rows_equal_reference(examples):
    """The header and the FCFS and VTC rows, exactly; Equinox's row is
    there, from the port's own experts."""
    text, tables, ref, _ = examples
    rows = {r["scheduler"]: r["line"] for r in tables["fairness"]["rows"]}
    assert list(rows) == ["fcfs", "vtc", "equinox"]
    want = {line.split()[0]: line for line in ref["fairness"][3:]}
    assert rows["fcfs"] == want["fcfs"] and rows["vtc"] == want["vtc"]
    printed = text.splitlines()
    start = printed.index(ref["fairness"][0])
    assert printed[start:start + 3] == ref["fairness"][:3]
    assert tables["fairness"]["requests"] == int(
        ref["fairness"][0].split("requests=")[1])


def test_fairness_equinox_row_with_bridged_experts(examples):
    """The port's scheduler loop given the reference's experts equals the
    reference's Equinox row."""
    from repro_torch.configs import get_config
    from repro_torch.core import SimConfig
    from repro_torch.predictor import MoPE
    from repro_torch.serving.costmodel import A100_80G, CostModel
    from repro_torch.weights import params_from_numpy
    from repro_torch.workloads import SCENARIOS, corpus

    _, _, ref, jax_mope = examples
    port = _load("fairness_comparison_torch")
    cm = CostModel(get_config("llama2-7b"), A100_80G)
    mope = MoPE(cm, corpus(6000, seed=0), epochs=1)
    mope.experts = [params_from_numpy(jax.tree.map(np.asarray, e), "cpu")
                    for e in jax_mope.experts]
    wl = SCENARIOS["balanced"](duration=8.0)
    rows = port.fairness_rows(cm, wl, SimConfig(max_batch=16,
                                                kv_budget_tokens=16000),
                              8.0, mope, schedulers=("equinox",))
    want = [line for line in ref["fairness"] if line.startswith("equinox")]
    assert [r["line"] for r in rows] == want
