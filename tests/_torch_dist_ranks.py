"""One rank of a CPU process group (gloo over a ``FileStore``: no network)
for the port's multi-rank tests.  The test starts one process per rank:

    python tests/_torch_dist_ranks.py JOB RANK WORLD STORE OUT

- ``ring``: the reference's three ring cases (``RING_CASES``) through
  ``ring_attention_sharded`` on a ``("data", "model")`` host mesh of WORLD
  x 1; rank 0 saves every case's global output and the in-process
  ``ring_attention_shards`` over WORLD shards to OUT (``.npz``).
- ``train``: smoke Llama-2 in f32, ``train(mesh=make_host_mesh(...))``
  for ``TRAIN_STEPS`` steps; rank 0 writes the losses to OUT (JSON).
- ``train_moe``: the same for smoke DeepSeek-MoE, which must be refused;
  rank 0 writes the refusal to OUT.
Imports no JAX.
"""
import json
import sys

import numpy as np

RING_CASES = [(64, 4, 2, True), (128, 8, 8, True), (64, 4, 4, False)]
TRAIN_STEPS = 3


def ring_inputs(S, Hq, Hkv):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, S, h, 16)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


def train_config():
    import dataclasses

    from repro_torch.configs import SMOKE_FACTORIES
    from repro_torch.training import TrainConfig

    cfg = dataclasses.replace(SMOKE_FACTORIES["llama2-7b"](),
                              dtype="float32")
    return cfg, TrainConfig(batch=4, seq_len=32, steps=TRAIN_STEPS,
                            warmup=1, log_every=1, seed=0)


def run_ranks(job, world, tmp_path, timeout=240):
    """Start ``world`` rank processes of ``job`` (PYTHONPATH=src), wait
    for all, fail with their stderr if any fails; returns OUT's path."""
    import os
    import pathlib
    import subprocess

    here = pathlib.Path(__file__).resolve()
    env = dict(os.environ, PYTHONPATH=str(here.parent.parent / "src"),
               OMP_NUM_THREADS="1")
    store, out = tmp_path / f"{job}.store", tmp_path / f"{job}.out"
    procs = [subprocess.Popen(
        [sys.executable, str(here), job, str(r), str(world), str(store),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errs, "\n".join(errs)
    return out


def main(job, rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(device="cpu")
        if job == "ring":
            from repro_torch.models.ring_attention import (
                ring_attention_shards, ring_attention_sharded)

            saved = {}
            for i, (S, Hq, Hkv, causal) in enumerate(RING_CASES):
                q, k, v = (torch.from_numpy(a)
                           for a in ring_inputs(S, Hq, Hkv))
                saved[f"ring{i}"] = ring_attention_sharded(
                    q, k, v, mesh, causal=causal).numpy()
                saved[f"shards{i}"] = ring_attention_shards(
                    q, k, v, world, causal=causal).numpy()
            if rank == 0:
                with open(out, "wb") as f:
                    np.savez(f, **saved)
        elif job == "train":
            from repro_torch.training import train

            cfg, tc = train_config()
            _, losses = train(cfg, tc, mesh=mesh, log=lambda m: None,
                              device="cpu")
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(losses, f)
        elif job == "train_moe":
            import dataclasses

            from repro_torch.configs import SMOKE_FACTORIES
            from repro_torch.training import train

            cfg = dataclasses.replace(SMOKE_FACTORIES["deepseek-moe-16b"](),
                                      dtype="float32")
            tc = train_config()[1]
            try:
                train(cfg, tc, mesh=mesh, log=lambda m: None, device="cpu")
                msg = "not refused"
            except NotImplementedError as e:
                msg = str(e)
            if rank == 0:
                with open(out, "w") as f:
                    f.write(msg)
        else:
            raise SystemExit(f"unknown job {job!r}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
