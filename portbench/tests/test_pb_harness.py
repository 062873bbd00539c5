"""The harness end to end on the CPU at the program's smoke sizes: the
tiny cells come out correct, the planted faults and the fp8 control do
not, the sample spreads over clients, and a new traffic file,
configuration or metric is found by name."""
import json
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from _pb_tiny import LIMIT, REPO, make_root, real_limits

from portbench import harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pb"))


def run(root, cell, seed=2**33 + 17, seconds=5.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu", root=root)


@pytest.mark.parametrize("cell", ["tiny-sc2", "tiny-ds"])
def test_tiny_cell_is_correct(root, cell):
    result, info = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["max_logit_gap"]["value"] <= 1e-4
    want = {m["name"] for m in harness.cell_metrics(cell, "end_to_end",
                                                    root)}
    assert want <= set(result["metrics"]), result["metrics"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and info["sampled_requests"]
    assert info["sampled_clients"] >= min(2, len(info["sampled_requests"]))
    if cell == "tiny-sc2":
        kv = info["kv_tokens_in_use"]
        assert 0 < kv["mean"] <= kv["max"] <= kv["pool"]
    else:
        assert "kv_tokens_in_use" not in info


def test_altered_token_is_caught(root, monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    calls = [0]

    def sample(self, row):
        calls[0] += 1
        tok = int(np.argmax(row))
        return (tok + 1) % len(row) if calls[0] % 7 == 0 else tok
    monkeypatch.setattr(ServingEngine, "_sample", sample)
    result, _ = run(root, "tiny-sc2")
    assert not result["correct"]
    assert result["checks"]["max_logit_gap"]["value"] > LIMIT


def test_kv_write_dropped_is_caught(root, monkeypatch):
    """A step that leaves its cache as it found it: the paged step's
    writes go to copies of the pools."""
    import repro_torch.serving.engine as E
    step = E._paged_decode_step

    def unchanged(params, tokens, ctx, bt, rmap, kp, vp, *rest, **kw):
        return step(params, tokens, ctx, bt, rmap, kp.clone(), vp.clone(),
                    *rest, **kw)
    monkeypatch.setattr(E, "_paged_decode_step", unchanged)
    result, _ = run(root, "tiny-sc2")
    assert not result["correct"]


def test_slot_cache_unchanged_is_caught(root, monkeypatch):
    """The slots backend's decode step writing into a copy of its cache."""
    import repro_torch.serving.engine as E
    decode = E.decode_step

    def unchanged(params, tokens, cache, cfg):
        copy = {"pos": cache["pos"], "stages": {
            k: {n: t.clone() for n, t in st.items()}
            for k, st in cache["stages"].items()}}
        logits, new = decode(params, tokens, copy, cfg)
        return logits, {"pos": new["pos"], "stages": cache["stages"]}
    monkeypatch.setattr(E, "decode_step", unchanged)
    result, _ = run(root, "tiny-ds")
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["tiny-sc2", "tiny-ds"])
def test_fp8_control_fails_the_limit(root, cell, monkeypatch):
    """The control: the reference in fp8 in the program's place, judged
    by the run's own comparison (``harness.check`` with the cell's
    limits), comes out not correct on the served tokens the program
    passes with."""
    got = {}
    real = harness.served_gaps

    def both(params, config, picked, prompts, device, fp8=False, **kw):
        gaps, ctrl = real(params, config, picked, prompts, device, fp8=True,
                          **kw)
        got["ctrl"] = ctrl
        return gaps, ctrl
    monkeypatch.setattr(harness, "served_gaps", both)
    result, info = run(root, cell)
    assert result["correct"]
    assert info["control_correct"] is False
    ok, checks = harness.check(got["ctrl"], {"limits": {
        "max_logit_gap": LIMIT, "min_tokens_compared": 0}})
    assert not ok and checks["max_logit_gap"]["value"] > LIMIT


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 17])
def test_fp8_control_fails_the_full_size_limit(seed):
    """StarCoder2's control at the smoke size over 12 requests of 40
    compared tokens, judged by ``harness.check`` with the full-size
    configuration's limits: not correct, on ``max_logit_gap`` and not
    only on the count of tokens.  (DeepSeek-MoE's control reads a mean
    gap of about 0.05 at the smoke size, under its full-size limit of
    0.09; its readings at full size are the chip's.)"""
    from _pb_tiny import tiny_config
    from portbench.weights import make_params
    cfg = tiny_config("sc2")
    params = make_params(cfg["model"], seed, "cpu")
    rng = np.random.default_rng(seed)
    picked, prompts = [], {}
    for rid in range(12):
        picked.append(_log(rid, f"c{rid % 4}", 40))
        picked[-1].tokens = rng.integers(0, 512, 40).tolist()
        prompts[rid] = rng.integers(0, 512, 48)
    _, ctrl = harness.served_gaps(params, cfg, picked, prompts, "cpu",
                                  fp8=True, cap=40)
    limits = real_limits("tiny-sc2")
    ok, checks = harness.check(ctrl, {"limits": limits})
    assert not ok and checks["tokens_compared"]["value"] >= 256
    assert checks["max_logit_gap"]["value"] > limits["max_logit_gap"]


def _log(rid, client, out, due=50.0):
    lg = harness.ReqLog(rid, client, due, 100, out)
    lg.tokens, lg.finished = list(range(out)), 60.0
    return lg


def test_sample_spreads_over_clients():
    """The longest finished request and then one a client in turn, each
    compared at no more than its cap of positions, first and last
    included; unfinished and pre-window requests never."""
    logs = [_log(0, "a0", 900)] + [
        _log(1 + i, f"{'ab'[i % 2]}{i % 4}", 60 + i) for i in range(40)]
    logs.append(_log(99, "a0", 2000))
    logs[-1].finished = None
    logs.append(_log(98, "b1", 3000))
    logs[-1].finished = 5.0
    mix = {"sample": {"min_tokens": 320, "min_requests": 8,
                      "max_requests": 24, "tokens_per_request": 40,
                      "max_ref_tokens": 10 ** 6}}
    picked = harness.sample(logs, mix, (10.0, 61.0), 2**33 + 3)
    assert picked[0].rid == 0 and len(picked) == 8
    assert {lg.client for lg in picked} == {"a0", "b1", "a2", "b3"}
    assert not {98, 99} & {lg.rid for lg in picked}
    again = harness.sample(logs, mix, (10.0, 61.0), 2**33 + 3)
    assert [lg.rid for lg in again] == [lg.rid for lg in picked]
    at = harness.compared_positions(900, 40)
    assert len(at) == 40 and at[0] == 0 and at[-1] == 899
    assert list(harness.compared_positions(7, 40)) == list(range(7))


def test_kv_in_use_share():
    """The paged pool's pages in use over the window's iterations."""
    read = harness.reader("kv_in_use_share")
    its = [harness.IterLog(t, t + 1, 0.1, 0, 4, [], [], 0, kv_pages=n)
           for t, n in ((0.0, 90), (11.0, 20), (13.0, 40), (30.0, 90))]
    rec = harness.Record({}, {}, (10.0, 20.0), 1.0, [], [], its, [],
                         kv_pool_pages=200)
    assert read(rec) == pytest.approx(15.0)
    rec.kv_pool_pages = None
    assert read(rec) is None


def test_new_files_are_found_by_name(root, tmp_path):
    """A traffic mix, a configuration and an end-to-end metric added as
    files (and entries) only."""
    import shutil
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    mix = json.loads((new / "portbench/traffic/tiny.json").read_text())
    mix["clients"][0]["count"] = 3
    mix["rate_rps"] = 3.0
    (new / "portbench/traffic/tiny-three.json").write_text(json.dumps(mix))
    cfg = json.loads((new / "portbench/configs/tiny-sc2.json").read_text())
    cfg["engine"]["max_slots"] = 4
    (new / "portbench/configs/tiny-sc2-4.json").write_text(json.dumps(cfg))
    (new / "portbench/metrics/requests_finished.py").write_text(
        textwrap.dedent('''\
        def read(rec):
            return sum(1 for lg in rec.requests if lg.finished is not None)
        '''))
    man = json.loads((new / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-sc2-4", "source": "x",
                           "file": "portbench/configs/tiny-sc2-4.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "tiny-three", "config": "tiny-sc2-4",
                             "traffic": "tiny-three", "chips": 1,
                             "why": "x"})
    man["end_to_end"].append({"name": "requests_finished", "unit": "count",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["tiny-three"]})
    (new / "BENCHMARK.json").write_text(json.dumps(man))
    result, _ = run(new, "tiny-three")
    assert result["metrics"]["requests_finished"]["value"] > 0
    # an end-to-end metric without a ``workloads`` list reaches the new
    # cell too
    assert "setup_s" in result["metrics"]
    from portbench.traffic.generator import schedule
    clients = {a.client for a in schedule(mix, 7, 10.0)}
    assert len(clients) == 3


def test_run_loads_neither_jax_nor_the_jax_package(root):
    """A whole tiny run in a fresh process; modules compared by their
    top-level name, whole."""
    code = textwrap.dedent(f'''\
        import sys, time
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / "src")!r}]
        from portbench import harness
        harness.run_cell("tiny-sc2", 5, 2.0, False, time.perf_counter(),
                         device="cpu", root={str(root)!r})
        print(harness.forbidden_modules())
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    bad, tops = out.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "repro_torch" in tops and "'repro'" not in tops


def test_trace_reduction():
    """Busy union, idle gaps named by the innermost span, breakdown."""
    tr = harness.TraceLog(0.0, 5.0, [("a", 0.0, 1.0), ("b", 0.5, 2.0),
                                     ("a", 3.0, 4.0), ("c", 6.0, 7.0)],
                          [("step", 0.0, 5.0), ("model_step", 2.2, 2.9)])
    assert harness.busy_intervals(tr.kernels, tr.t0, tr.t1) == [[0.0, 2.0],
                                                                [3.0, 4.0]]
    assert harness.idle_gaps(tr) == [("model_step", 1.0), ("step", 1.0)]
    b = harness.breakdown(tr)
    assert b["device_ops"][0] == ["a", 2.0] and len(b["idle_gaps"]) == 2
