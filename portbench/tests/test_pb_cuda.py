"""The harness on the card at the program's smoke sizes: the tiny cells
through the CUDA kernels, traced (profiler slice, breakdown, device
metrics), correct against the reference, and the fp8 control not correct
by the run's own comparison.  Skipped without a CUDA device."""
import time

import pytest

from _pb_tiny import LIMIT, make_root

from portbench import harness


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only "
                    "on the card")
    return make_root(tmp_path_factory.mktemp("pbcuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-sc2", "tiny-ds"])
def test_tiny_cell_traced_on_the_card(card_root, cell, monkeypatch):
    got = {}
    real = harness.served_gaps

    def both(params, config, picked, prompts, device, fp8=False, **kw):
        gaps, ctrl = real(params, config, picked, prompts, device, fp8=True,
                          **kw)
        got["ctrl"] = ctrl
        return gaps, ctrl
    monkeypatch.setattr(harness, "served_gaps", both)
    result, info = harness.run_cell(cell, 2**33 + 5, 4.0, True,
                                 time.perf_counter(), device="cuda",
                                 root=card_root)
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
    roof = result["metrics"].get("paged_attn_roofline",
                                 result["metrics"].get(
                                     "paged_attn_roofline.overload"))
    assert roof is not None and 0 < roof["value"] <= 105
    assert info["control_correct"] is False
    ok, checks = harness.check(got["ctrl"], {"limits": {
        "max_logit_gap": LIMIT, "min_tokens_compared": 0}})
    assert not ok and checks["max_logit_gap"]["value"] > LIMIT
