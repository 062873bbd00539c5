"""Multi-replica fair cluster serving on the PyTorch port (the
counterpart of ``cluster_serving.py``).

Spins up a 4-replica simulated cluster (A100 cost model), shares the
per-client VTC counters across replicas, and shows the no-gaming
property: a client that sprays 4x the traffic over every replica is
still held to an equal weighted-service share while a well-behaved
client stays backlogged.  The replicas are the port's copy of the
discrete-event simulator: no tensor work runs, on the card or on the
CPU, so the example takes no ``--device``.

    PYTHONPATH=src python examples/cluster_serving_torch.py
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import Request, SimConfig
from repro_torch.serving.cluster import make_sim_cluster
from repro_torch.serving.costmodel import A100_80G, CostModel

POLICIES = ("round_robin", "least_kv", "min_ttft")


def two_client_overload(duration=10.0):
    """'flood' sends 60 req/s, 'polite' 15 req/s — both above their fair
    share of the 4-replica cluster, so fairness is actually contested."""
    reqs, rid = [], 0
    for client, rate in (("flood", 60.0), ("polite", 15.0)):
        t = 0.0
        while t < duration:
            t += 1.0 / rate
            reqs.append(Request(rid=rid, client=client, arrival=t,
                                prompt_len=50, output_len=100,
                                keywords=("chat",)))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival)


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    cm = CostModel(get_config("llama2-7b"), A100_80G)

    table = []
    for policy in POLICIES:
        cluster = make_sim_cluster(
            4, cm, scheduler="vtc", policy=policy,
            sim_cfg=SimConfig(max_batch=8, kv_budget_tokens=4000))
        res = cluster.run(two_client_overload(), max_time=10.0)
        svc = res.per_client_service()
        share = svc["flood"] / (svc["flood"] + svc["polite"])
        s = res.summary()
        line = (f"policy={policy:<12} tput={s['throughput_tok_s']:7.0f} "
                f"tok/s p50_ttft={s['p50_ttft']:.2f}s "
                f"flood_share={share:.2f} per_replica={s['per_replica']}")
        print(line)
        table.append({"policy": policy,
                      "throughput_tok_s": s["throughput_tok_s"],
                      "p50_ttft": s["p50_ttft"], "flood_share": share,
                      "per_replica": list(s["per_replica"]), "line": line})

    print("\nflood sends 4x the traffic of polite, sprayed over every "
          "replica;\nglobal counters hold its service share near 0.50 "
          "under all routing policies.")
    return table


if __name__ == "__main__":
    main()
