"""The plain references against the program's engine on the CPU at the
program's smoke sizes: the first-token logits after chunked prefill
(paged pools; slot caches) and the decode logits through the cache,
teacher-forced on the engine's own tokens.  Only this test imports both
sides."""
import numpy as np
import pytest
import torch

from _pb_tiny import tiny_config

from portbench import harness
from portbench.weights import make_params


@pytest.mark.parametrize("which", ["sc2", "ds"])
def test_engine_logits_equal_the_reference(which):
    from repro_torch.core.request import Request
    config = tiny_config(which)
    cfg = harness.build_cfg(config)
    params = make_params(config["model"], 2**40 + 3, "cpu")
    eng = harness.build_engine(config, cfg, params, "cpu")
    eng.keep_first_logits = True
    rows = {}
    sample = type(eng)._sample

    def keep(row):
        keep.rid_rows.append(np.asarray(row, np.float32))
        return sample(eng, row)
    keep.rid_rows = []
    rng = np.random.default_rng(0)
    # prompts longer than the 128-token chunk: prefill runs in chunks
    reqs = [Request(rid=i, client=f"c{i % 2}", arrival=0.0,
                    prompt_len=int(n), output_len=6, keywords=("code",))
            for i, n in enumerate((40, 200, 300))]
    for r in reqs:
        r.prompt_tokens = rng.integers(0, 512, r.prompt_len).astype(np.int32)
    eng._sample = keep
    # decode rows of one request at a time, to know whose row is whose
    for r in reqs:
        keep.rid_rows = []
        eng.run([r])
        rows[r.rid] = [r._first_row] + keep.rid_rows
    ref = harness.reference_module(config)
    for r in reqs:
        got = np.stack(rows[r.rid])                       # (n, V)
        toks = np.argmax(got, -1)
        seq = np.concatenate([r.prompt_tokens, toks[:-1]]).astype(np.int64)
        want = ref.logits(params, config["model"], [torch.from_numpy(seq)],
                          [torch.arange(r.prompt_len - 1,
                                        r.prompt_len - 1 + len(toks))],
                          device="cpu")[0].numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale, (
            which, r.rid, np.abs(got - want).max(), scale)
