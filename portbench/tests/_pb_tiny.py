"""A checkout of the benchmark with two tiny cells for CPU tests: the
benchmark's files copied under ``root``, configurations of each family at
the program's smoke sizes in float32 (``tiny-sc2``: the paged backend;
``tiny-ds``: slots with a MoE stack), and a short mix."""
import json
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "sc2": ("starcoder2-7b-paged", dict(
        n_layers=2, d_model=144, n_heads=6, n_kv_heads=2, d_ff=288,
        vocab_size=512, dtype="float32")),
    "ds": ("deepseek-moe-16b-slots", dict(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32")),
}
TINY_MOE = dict(n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=64,
                d_ff_shared=64, first_k_dense=1, capacity_factor=5.0)
LIMIT = 0.05     # the f32 program reads 0 on these cells


def tiny_config(which):
    base, small = SMALL[which]
    cfg = json.loads((REPO / "portbench" / "configs"
                      / f"{base}.json").read_text())
    cfg["model"].update(small, head_dim=small["d_model"] // small["n_heads"])
    cfg["overrides"] = dict(small, attn_impl="naive")
    if which == "ds":
        cfg["model"]["moe"] = dict(TINY_MOE)
        cfg["overrides"].update({f"moe.{k}": v for k, v in TINY_MOE.items()})
    cfg["engine"].update(max_slots=8, max_len=512, kv_budget_tokens=4096,
                         prefill_chunk_tokens=128)
    cfg["limits"] = {"max_logit_gap": LIMIT, "min_tokens_compared": 16}
    return cfg


def tiny_mix(traffic="code-ctx"):
    mix = json.loads((REPO / "portbench" / "traffic"
                      / f"{traffic}.json").read_text())
    for g in mix["clients"]:
        for k in ("prompt", "output"):
            spec = g.get(k, {})
            if spec.get("dist") == "lognormal":
                for f in ("median", "min", "max"):
                    spec[f] = max(4, spec[f] // 32)
    mix.update(rate_rps=6.0, ramp_s=1.0)
    mix["sample"].update(min_tokens=24, min_requests=4, tokens_per_request=8)
    return mix


def real_limits(cell):
    """The limits of the full-size configuration a tiny cell is cut
    from."""
    base = SMALL[cell.split("-")[1]][0]
    return json.loads((REPO / "portbench" / "configs"
                       / f"{base}.json").read_text())["limits"]


def make_root(root: pathlib.Path) -> pathlib.Path:
    """A checkout under ``root`` with cells ``tiny-sc2`` and ``tiny-ds``
    added to BENCHMARK.json (every metric reported in them)."""
    root = pathlib.Path(root)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps(tiny_mix()))
    for which in SMALL:
        f = f"portbench/configs/tiny-{which}.json"
        (root / f).write_text(json.dumps(tiny_config(which)))
        man["configs"].append({"name": f"tiny-{which}", "source": "x",
                               "file": f, "reduced": [], "why": "x"})
        man["workloads"].append({"name": f"tiny-{which}",
                                 "config": f"tiny-{which}",
                                 "traffic": "tiny", "chips": 1, "why": "x"})
        for m in man["end_to_end"] + man["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(f"tiny-{which}")
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root
