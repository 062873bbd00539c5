"""The frozen traffic: one seed gives one schedule; every seed the same
lengths per client in another order; each mix's medians and clips."""
import json

import numpy as np
import pytest

from _pb_tiny import REPO

from portbench.traffic import generator

MIXES = {"code-ctx": {"prompt": (2048, 512, 7168), "output": (48, 8, 256)},
         "mixed-overload": {"prefill": ((1024, 512, 1536), (32, 16, 64)),
                            "decode": ((96, 32, 256), (512, 256, 1024))},
         "chat-overload": None}


def mix(name):
    return json.loads((REPO / f"portbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(MIXES))
def test_one_seed_one_schedule(name):
    a = generator.schedule(mix(name), 2**35 + 1, 120.0)
    b = generator.schedule(mix(name), 2**35 + 1, 120.0)
    c = generator.schedule(mix(name), 2**35 + 2, 120.0)
    assert [vars(x) for x in a] == [vars(x) for x in b]
    assert all(0 <= x.due < 120.0 for x in a)
    # another seed: the same arrivals and the same sizes, in another
    # order, shuffled only among each block of consecutive arrivals (a
    # block of 1: the same order, one fixed trace)
    assert [(x.due, x.client) for x in a] == [(x.due, x.client) for x in c]
    sizes = lambda s: sorted((x.prompt_len, x.output_len) for x in s)
    assert sizes(a) == sizes(c)
    moved = sum((x.prompt_len, x.output_len) != (y.prompt_len, y.output_len)
                for x, y in zip(a, c))
    block = mix(name).get("shuffle_block", 8)
    assert moved > len(a) // 2 if block > 1 else moved == 0
    for g in {x.client.rstrip("0123456789") for x in a}:
        ia = [x for x in a if x.client.rstrip("0123456789") == g]
        ic = [x for x in c if x.client.rstrip("0123456789") == g]
        for i in range(0, len(ia), block):
            assert sizes(ia[i:i + block]) == sizes(ic[i:i + block])


def test_prompt_tokens_follow_the_seed():
    t = generator.prompt_tokens(2**34, 5, 100, 49152)
    assert (t == generator.prompt_tokens(2**34, 5, 100, 49152)).all()
    assert not (t == generator.prompt_tokens(2**34 + 1, 5, 100, 49152)).all()
    assert t.min() >= 0 and t.max() < 49152


def _check(lengths, median, lo, hi):
    assert lengths.min() >= lo and lengths.max() <= hi
    assert abs(np.median(lengths) - median) <= 0.05 * median


def test_code_ctx_lengths():
    s = generator.schedule(mix("code-ctx"), 3, 3000.0)
    for k, attr in (("prompt", "prompt_len"), ("output", "output_len")):
        _check(np.array([getattr(x, attr) for x in s]), *MIXES["code-ctx"][k])
    assert len({x.client for x in s}) == 16


def test_mixed_overload_lengths_and_demand():
    m = mix("mixed-overload")
    s = generator.schedule(m, 3, 3000.0)
    demand = {}
    for grp, (p, o) in MIXES["mixed-overload"].items():
        xs = [x for x in s if x.client.startswith(grp)]
        _check(np.array([x.prompt_len for x in xs]), *p)
        _check(np.array([x.output_len for x in xs]), *o)
        for x in xs:
            demand[x.client] = demand.get(x.client, 0) + x.prompt_len \
                + generator.OUT_TOKEN_WEIGHT * x.output_len
    v = np.array(list(demand.values()))
    assert len(v) == 8 and v.max() / v.min() < 1.1     # equal demand


def test_chat_lengths_follow_the_frozen_model():
    s = generator.schedule(mix("chat-overload"), 3, 600.0)
    p = np.array([x.prompt_len for x in s])
    o = np.array([x.output_len for x in s])
    assert p.min() >= 4 and p.max() <= 3500 and o.max() <= 4096
    assert 70 <= np.median(p) <= 100          # exp(4.45) = 85.6
    assert len({x.client for x in s}) == 8
    assert all(x.keywords[0] in generator.lmsys.INTENTS for x in s)
