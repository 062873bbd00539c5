"""One rank of a CPU process group (gloo over a ``FileStore``: no network)
for the port's multi-rank tests.  The test starts one process per rank:

    python tests/_torch_dist_ranks.py JOB RANK WORLD STORE OUT

- ``ring``: the reference's three ring cases (``RING_CASES``) through
  ``ring_attention_sharded`` on a ``("data", "model")`` host mesh of WORLD
  x 1, forward and backward at ``ring_dout``; rank 0 saves every case's
  global output and the in-process ``ring_attention_shards`` over WORLD
  shards, forward and gradients, to OUT (``.npz``), and every rank the
  gradients that reached its global q, k, v to ``OUT.rank<rank>.npz``.
- ``channels``: the channel-parallel RG-LRU cases of ``CHANNEL_CASES``
  whose mesh holds WORLD ranks: step 0's gradients (reduced as
  ``train(mesh=...)`` reduces them, gathered whole), the widths
  ``linear_scan`` saw, each RG-LRU leaf's gather steps and one step's
  collectives as counted and as scheduled; rank 0 writes them to OUT
  (JSON) and the gradients to ``OUT.<case>.grads.npz``.
- ``train``: smoke Llama-2 in f32, ``train(mesh=make_host_mesh(...))``
  for ``TRAIN_STEPS`` steps; rank 0 writes the losses to OUT (JSON).
- ``train_model_axis``: the same on a (1, WORLD) mesh: a ``"model"``
  axis, the weights gathered at use.
- ``train_moe``: the same for smoke DeepSeek-MoE over WORLD data ranks.
- ``tp2`` / ``tp4``: every case of ``TP_CASES`` whose mesh holds WORLD
  ranks; rank 0 writes each case's losses (and the clip case's step-0
  gradient norm, the counted cases' collectives of one step as counted
  and as ``ShardPlan.step_schedule`` derives them) to OUT (JSON) and each
  case's final parameters, gathered whole, to ``OUT.<case>.npz`` (and
  each rank its initial shards to ``OUT.<case>.shard<rank>.npz``); the
  checkpoint case writes ``train``'s own file under ``OUT.ckpt``; a
  ``reference`` case starts from the weights the test wrote beside OUT
  (``<case>.weights.npz``: the reference's, drawn by JAX).
- ``serve_tp2`` / ``serve_tp4``: every case of ``SERVE_CASES`` whose mesh
  holds WORLD ranks, under a ``ServePlan``: ``prefill``, ``SERVE_DECODE``
  teacher-forced ``decode_step`` calls and, where the stack takes it, one
  ``prefill_chunk`` (``serve_inputs``: the frames or patches of an
  encoder-decoder or a vision stack too); each rank writes its rows' whole
  logits of every call and its cache shards after the last to
  ``OUT.rank<rank>.npz`` (``<case>/...``), and its shards' bytes and
  each call's counted collectives beside ``serve_schedule``'s to
  ``OUT.rank<rank>.json``; every rank draws the whole tree by
  ``init_params`` at seed 0 and keeps its shards.
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


def ring_dout(S, Hq, Hkv):
    """The output's gradient of a ring case: the next draw of
    ``ring_inputs``' generator."""
    rng = np.random.default_rng(0)
    for h in (Hq, Hkv, Hkv):
        rng.standard_normal((2, S, h, 16))
    return rng.standard_normal((2, S, Hq, 16)).astype(np.float32)


def train_config():
    import dataclasses

    from repro_torch.configs import SMOKE_FACTORIES
    from repro_torch.training import TrainConfig

    cfg = dataclasses.replace(SMOKE_FACTORIES["llama2-7b"](),
                              dtype="float32")
    return cfg, TrainConfig(batch=4, seq_len=32, steps=TRAIN_STEPS,
                            warmup=1, log_every=1, seed=0)


# the weights-gathered-at-use cases: name -> (arch, (data, model) mesh,
# config fields replaced, run options: ``grad_clip``, the MoE dispatch's
# ``chunk`` (DISPATCH_CHUNK_TOKENS for the run), ``ckpt``, ``count``: one
# step's collectives counted, ``shards``: every rank's initial shards
# saved, ``reference``: from the reference's weights, held to its
# ``train``: True, its losses and final parameters; ``"losses"``, its
# losses alone)
TP_CASES = {
    "llama_model2": ("llama2-7b", (1, 2), {}, {}),
    "granite_model2_remat": ("granite-3-2b", (1, 2), {"remat": True},
                             {"ckpt": True}),
    "llama_fsdp_data2": ("llama2-7b", (2, 1), {"fsdp": True}, {}),
    "mamba2_model2": ("mamba2-2.7b", (1, 2), {}, {}),
    "minicpm3_model2": ("minicpm3-4b", (1, 2), {}, {}),
    "whisper_model2": ("whisper-large-v3", (1, 2), {}, {}),
    "internvl2_model2": ("internvl2-76b", (1, 2), {}, {}),
    # the RG-LRU branch channel-parallel over the model axis (the batch
    # kept off it); the same over (2, 2) with fsdp and remat, and from the
    # reference's weights, held to the reference's losses (its final
    # parameters to train()'s: from these weights train() in one process
    # ends 1.07e-5 from the reference's at stages/stage_0/ffn/w_in, past
    # the 1e-5 bound, Adam moving elements whose gradients sit at rounding
    # level)
    "rgemma_model2_channels": ("recurrentgemma-2b", (1, 2),
                               {"train_batch_over_model": False}, {}),
    "rgemma_fsdp_2x2_remat": ("recurrentgemma-2b", (2, 2),
                              {"train_batch_over_model": False,
                               "fsdp": True, "remat": True},
                              {"count": True}),
    "rgemma_model2_channels_ref": ("recurrentgemma-2b", (1, 2),
                                   {"train_batch_over_model": False},
                                   {"reference": "losses"}),
    "moe_dense_data2": ("deepseek-moe-16b", (2, 1), {"moe_impl": "dense"},
                        {"count": True}),
    "moe_dispatch_data2": ("deepseek-moe-16b", (2, 1),
                           {"moe_impl": "dispatch", "capacity_factor": 1.0},
                           {}),
    # 128 tokens in chunks of 48: the second chunk spans both ranks, the
    # third ends in 16 zero rows on the last rank
    "moe_dispatch_chunk48_data2": ("deepseek-moe-16b", (2, 1),
                                   {"moe_impl": "dispatch",
                                    "capacity_factor": 1.0},
                                   {"chunk": 48, "count": True}),
    # a clip that binds at every step
    "llama_model2_clip": ("llama2-7b", (1, 2), {}, {"grad_clip": 0.05}),
    "llama_fsdp_2x2_remat": ("llama2-7b", (2, 2), {"fsdp": True,
                                                   "remat": True},
                             {"count": True, "shards": True}),
    # the model axis with fsdp and remat, and the chunk that spans the
    # ranks, from the reference's weights
    "llama_fsdp_2x2_remat_ref": ("llama2-7b", (2, 2), {"fsdp": True,
                                                       "remat": True},
                                 {"reference": True}),
    "moe_dispatch_chunk48_data2_ref": ("deepseek-moe-16b", (2, 1),
                                       {"moe_impl": "dispatch",
                                        "capacity_factor": 1.0},
                                       {"chunk": 48, "reference": True}),
}


# serving over a mesh (``ServePlan``): name -> (arch, (data, model) mesh,
# config fields replaced); smoke configs in f32
SERVE_CASES = {
    "llama_model2": ("llama2-7b", (1, 2), {}),
    # 8 query heads over 2 kv heads, tied embeddings
    "granite_model2": ("granite-3-2b", (1, 2), {}),
    # E = 4 over the model axis, window 32, a prompt past it
    "mixtral_model2": ("mixtral-8x7b", (1, 2), {}),
    # experts over the model axis (the dispatch), a shared expert, a
    # dense first stage
    "deepseek_moe_model2": ("deepseek-moe-16b", (1, 2),
                            {"moe_impl": "dispatch"}),
    "llama_model2_int8": ("llama2-7b", (1, 2), {"kv_quant": True}),
    # MLA over heads (2 of 4 a rank), c over the latent rank
    "minicpm3_model2": ("minicpm3-4b", (1, 2), {}),
    # in_proj's 552 columns, 276 a rank (z and 20 of x on rank 0: not
    # head-aligned), 4 of 8 heads a rank; the same with 2 B/C groups
    # (each rank's heads in one group)
    "mamba2_model2": ("mamba2-2.7b", (1, 2), {}),
    "mamba2_groups2_model2": ("mamba2-2.7b", (1, 2), {"n_groups": 2}),
    # the RG-LRU branch on 64 of 128 channels; local attention "mixed"
    # (4 query heads, 1 kv head), window 32, a prompt past it
    "rgemma_model2": ("recurrentgemma-2b", (1, 2), {}),
    "llama_data2": ("llama2-7b", (2, 1), {}),
    # 6 heads of 24 over 2 kv heads: every projection over the head dim
    "starcoder_model4": ("starcoder2-7b", (1, 4), {}),
    # q over heads, k/v over the head dim; the same with int8 caches
    # (each scale from the absmax over the four ranks' slices)
    "granite_model4": ("granite-3-2b", (1, 4), {}),
    "granite_model4_int8": ("granite-3-2b", (1, 4), {"kv_quant": True}),
    # 2 experts over 4 ranks: the expert hidden dim split, the dispatch
    "mixtral_e2_model4": ("mixtral-8x7b", (1, 4),
                          {"moe_impl": "dispatch", "n_experts": 2}),
    # 2 MLA heads over 4 ranks: wq_b/wkv_b whole, wo over v_head_dim
    "minicpm3_h2_model4": ("minicpm3-4b", (1, 4), {"n_heads": 2,
                                                   "n_kv_heads": 2}),
    # 2 of 8 Mamba-2 heads a rank
    "mamba2_model4": ("mamba2-2.7b", (1, 4), {}),
    # Whisper's encoder-decoder: 2 of 4 heads a rank in the encoder, the
    # decoder and the cross-attention (its caches over heads); with 2
    # heads of 64 over 4 ranks every projection of all three over the
    # head dim; its frames and cross caches over the data axis
    "whisper_model2": ("whisper-large-v3", (1, 2), {}),
    "whisper_h2_model4": ("whisper-large-v3", (1, 4), {"n_heads": 2,
                                                       "n_kv_heads": 2}),
    "whisper_data2": ("whisper-large-v3", (2, 1), {}),
    # InternVL2's 8 patches ahead of the tokens: 4 of 8 query heads over
    # 1 of 2 kv heads a rank; over 4 ranks "mixed"
    "internvl_model2": ("internvl2-76b", (1, 2), {}),
    "internvl_model4": ("internvl2-76b", (1, 4), {}),
}
SERVE_BATCH, SERVE_MAX_LEN, SERVE_DECODE, SERVE_CHUNK = 2, 64, 4, 6


def serve_case(name):
    """(cfg in f32, (data, model)) of a ``SERVE_CASES`` entry."""
    import dataclasses

    from repro_torch.configs import SMOKE_FACTORIES

    arch, shape, fields = SERVE_CASES[name]
    cfg = SMOKE_FACTORIES[arch]()
    fields = dict(fields)
    if "n_experts" in fields:
        fields["moe"] = dataclasses.replace(
            cfg.moe, n_experts=fields.pop("n_experts"))
    if "n_groups" in fields:
        fields["ssm"] = dataclasses.replace(
            cfg.ssm, n_groups=fields.pop("n_groups"))
    return dataclasses.replace(cfg, dtype="float32", attn_impl="flash",
                               **fields), shape


def serve_inputs(cfg):
    """(prompt tokens (B, S), the decode steps' tokens (SERVE_DECODE, B),
    the chunk's tokens (B, SERVE_CHUNK) or None where the stack takes no
    ``prefill_chunk``, the prefill batch's stubbed frontend inputs: an
    encoder-decoder's ``frames`` or a vision stack's ``patch_embeds``, (B,
    n_frontend_tokens, d) f32 standard normals drawn after the tokens, or
    none): S past a window where the stack has one."""
    from repro_torch.models.model import supports_chunked_prefill

    S = cfg.window + 8 if cfg.window else 24
    rng = np.random.default_rng(7)
    draw = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, S + SERVE_DECODE
                                            + SERVE_CHUNK)).astype(np.int64)
    chunk = draw[:, S + SERVE_DECODE:] if supports_chunked_prefill(cfg) \
        else None
    stub = {}
    if cfg.frontend != "text":
        key = "frames" if cfg.is_encoder_decoder else "patch_embeds"
        stub[key] = rng.standard_normal(
            (SERVE_BATCH, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)
    return draw[:, :S], draw[:, S:S + SERVE_DECODE].T.copy(), chunk, stub


def serve_run(name, mesh):
    """One ``SERVE_CASES`` case on this rank: (arrays, the JSON part)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.specs import param_structs, tree_placements
    from repro_torch.models.model import (decode_step, init_cache, prefill,
                                          prefill_chunk)
    from repro_torch.models.sharding import (ServePlan, activate,
                                             cache_specs, param_specs)
    from repro_torch.weights import init_params

    cfg, _ = serve_case(name)
    prompt, steps, chunk, stub = serve_inputs(cfg)
    B, S = prompt.shape
    # the prefill's positions count the patches; the cross caches' frames
    positions = S + cfg.n_frontend_tokens * (cfg.frontend == "vision_stub")
    enc_len = cfg.n_frontend_tokens * cfg.is_encoder_decoder
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = ServePlan(mesh, cfg, B)
    plan.shard_params(params)
    arrays, calls = {}, []
    comm = plan.comm

    def counted(fn, shape, cache_len=None):
        before = {k: dict(v) for k, v in (("bytes", comm.bytes),
                                          ("counts", comm.counts))}
        got = fn()
        calls.append({
            "counted": {k: {kind: getattr(comm, k)[kind] - before[k][kind]
                            for kind in before[k]}
                        for k in ("bytes", "counts")},
            "schedule": plan.serve_schedule(cfg, shape, cache_len)})
        return got

    rows = plan.rows_of
    with activate(plan):
        batch = {k: rows(torch.from_numpy(v)) for k, v in
                 dict(stub, tokens=prompt).items()}
        logits, cache = counted(lambda: prefill(
            params, batch, cfg, SERVE_MAX_LEN),
            ShapeConfig("p", positions, B, "prefill"), SERVE_MAX_LEN)
        arrays["logits/prefill"] = plan.whole_logits(logits).numpy()
        for i, toks in enumerate(steps):
            logits, cache = counted(lambda: decode_step(
                params, rows(torch.from_numpy(toks)), cache, cfg),
                ShapeConfig("d", 1, B, "decode"), SERVE_MAX_LEN)
            arrays[f"logits/decode{i}"] = plan.whole_logits(logits).numpy()
        if chunk is not None:
            logits, cache = counted(lambda: prefill_chunk(
                params, rows(torch.from_numpy(chunk)), cfg, cache),
                ShapeConfig("c", chunk.shape[1], B, "chunk"), SERVE_MAX_LEN)
            arrays["logits/chunk"] = plan.whole_logits(logits).numpy()
        zeros = init_cache(cfg, B, SERVE_MAX_LEN, device="cpu",
                           enc_len=enc_len)
    # int8 caches' bf16 scales saved in f32 (exact)
    arrays.update({f"cache/{k}": v for k, v in flat(_tree_map(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t,
        cache)).items()})
    whole_cache = init_cache(cfg, B, SERVE_MAX_LEN, device="meta",
                             enc_len=enc_len)
    structs = param_structs(cfg)
    nbytes = {
        "params": _nbytes(params),
        "params_placed": local_bytes(structs, tree_placements(
            param_specs(structs, cfg, mesh), mesh), mesh),
        "cache": _nbytes(cache),
        "init_cache": _nbytes(zeros),
        "cache_placed": local_bytes(whole_cache, tree_placements(
            cache_specs(whole_cache, cfg, mesh, B), mesh), mesh)}
    return arrays, {"bytes": nbytes, "calls": calls,
                    "layout": plan.layout, "cross_layout": plan.cross_layout,
                    "rows": [plan.rows.index, plan.rows.count]}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _nbytes(tree):
    """The bytes of a tree of tensors."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# the channel-parallel RG-LRU cases of the ``channels`` job
CHANNEL_CASES = ("rgemma_model2_channels", "rgemma_fsdp_2x2_remat")


def tp_case(name):
    """(cfg in f32, TrainConfig, (data, model), options) of a
    ``TP_CASES`` entry."""
    import dataclasses

    from repro_torch.configs import SMOKE_FACTORIES

    arch, shape, fields, opts = TP_CASES[name]
    base = SMOKE_FACTORIES[arch]()
    fields = dict(fields, dtype="float32")
    cf = fields.pop("capacity_factor", None)
    if cf is not None:
        fields["moe"] = dataclasses.replace(base.moe, capacity_factor=cf)
    cfg = dataclasses.replace(base, **fields)
    tc = dataclasses.replace(train_config()[1],
                             grad_clip=opts.get("grad_clip", 1.0))
    return cfg, tc, shape, opts


def moe_config():
    """Smoke DeepSeek-MoE in f32 (``moe_impl="dense"``) and
    ``train_config``'s TrainConfig."""
    import dataclasses

    from repro_torch.configs import SMOKE_FACTORIES

    cfg = dataclasses.replace(SMOKE_FACTORIES["deepseek-moe-16b"](),
                              dtype="float32")
    return cfg, train_config()[1]


def start_ranks(job, world, tmp_path):
    """Start ``world`` rank processes of ``job`` (PYTHONPATH=src); returns
    (the processes, OUT's path)."""
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
    return procs, out


def wait_ranks(procs, timeout=240):
    """Wait for every rank process, fail with their stderr if any
    fails."""
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


def run_ranks(job, world, tmp_path, timeout=240):
    """``start_ranks``, then ``wait_ranks``; returns OUT's path."""
    procs, out = start_ranks(job, world, tmp_path)
    wait_ranks(procs, timeout)
    return out


def flat(tree, prefix=""):
    """{path: numpy array} of a tree of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy()
    return out


def unflat(arrays):
    """{path: array} -> the nested tree ``flat`` flattened."""
    tree = {}
    for path, a in arrays.items():
        *keys, leaf = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def reference_weights_path(out, name):
    """Where the test writes a ``reference`` case's initial weights."""
    import pathlib

    return pathlib.Path(out).with_name(f"{name}.weights.npz")


def tp_run(name, world, out, rank):
    """One ``TP_CASES`` case on this rank: ``train(mesh=...)``, its
    losses and whole final parameters (and the options' extras) into
    ``result``."""
    from repro_torch.launch.mesh import join_ranks, make_host_mesh
    from repro_torch.launch.specs import param_structs
    from repro_torch.models import moe
    from repro_torch.models.sharding import gather_tree, param_specs
    from repro_torch.training import train

    cfg, tc, (data, model), opts = tp_case(name)
    assert data * model == world
    mesh = make_host_mesh(model=model, device="cpu")
    if opts.get("ckpt"):
        import dataclasses
        tc = dataclasses.replace(tc, ckpt_path=f"{out}.ckpt")
    start = None
    if opts.get("reference"):
        from repro_torch.weights import params_from_numpy

        with np.load(reference_weights_path(out, name)) as f:
            start = params_from_numpy(unflat(dict(f)), "cpu")
    chunk = moe.DISPATCH_CHUNK_TOKENS
    moe.DISPATCH_CHUNK_TOKENS = opts.get("chunk", chunk)
    try:
        params, losses = train(cfg, tc, mesh=mesh, log=lambda m: None,
                               device="cpu", params=start)
    finally:
        moe.DISPATCH_CHUNK_TOKENS = chunk
    whole = gather_tree(params, param_specs(param_structs(cfg), cfg, mesh),
                        mesh)
    result = {"losses": losses}
    if rank == 0:
        np.savez(f"{out}.{name}.npz", **flat(whole))
    if opts.get("grad_clip", 1.0) < 1.0:
        result["step0_norm"] = float(step0_norm(cfg, tc, mesh))
    if opts.get("shards"):
        np.savez(f"{out}.{name}.shard{rank}.npz",
                 **flat(_placed(cfg, tc, mesh)[1]))
    if opts.get("count"):
        moe.DISPATCH_CHUNK_TOKENS = opts.get("chunk", chunk)
        try:
            result["collectives"] = one_step_collectives(cfg, tc, mesh)
        finally:
            moe.DISPATCH_CHUNK_TOKENS = chunk
    return result


def _placed(cfg, tc, mesh):
    """A ``MeshTrainer`` and the weights from ``tc.seed`` placed by it,
    requiring gradients, and step 0's batch rows (this rank's)."""
    import torch

    from repro_torch.training.data import batches
    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import MeshTrainer
    from repro_torch.weights import init_params

    mt = MeshTrainer(cfg, tc, mesh)
    params = mt.place(init_params(cfg, torch.Generator().manual_seed(
        tc.seed), "cpu"))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    b = mt.rows(next(batches(cfg.vocab_size, tc.batch, tc.seq_len, 1,
                             tc.seed)))
    return mt, params, {k: torch.from_numpy(v) for k, v in b.items()}


def step0_norm(cfg, tc, mesh):
    """The clip's norm of step 0's gradient, summed over the ranks, from
    the shards (``ShardPlan.global_norm``, the norm ``make_train_step``
    gives the clip)."""
    import torch

    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import activate
    from repro_torch.training.optim import tree_leaves

    mt, params, batch = _placed(cfg, tc, mesh)
    with activate(mt.plan):
        grads = torch.autograd.grad(loss_fn(params, batch, cfg),
                                    tree_leaves(params))
        mt.plan.reduce_grads_(grads)
        return mt.plan.global_norm(list(grads))


def one_step_collectives(cfg, tc, mesh):
    """One ``train(mesh=...)`` step's collectives as this rank counted
    them (``Collectives``), beside ``ShardPlan.step_schedule``'s."""
    from repro_torch.models.sharding import activate
    from repro_torch.training.optim import AdamW
    from repro_torch.training.trainer import make_train_step

    mt, params, batch = _placed(cfg, tc, mesh)
    opt = AdamW(lr=1e-3, grad_clip=tc.grad_clip)
    state = opt.init(params)
    with activate(mt.plan):
        make_train_step(cfg, opt, mt.plan)(params, state, batch)
    comm, n_tokens = mt.plan.comm, tc.batch * tc.seq_len
    return {"counted": {"bytes": comm.bytes, "counts": comm.counts},
            "schedule": mt.plan.step_schedule(n_tokens, bool(tc.grad_clip)),
            "channel_terms": mt.plan.channel_schedule(n_tokens)}


def channel_run(name, mesh):
    """One ``CHANNEL_CASES`` case on this rank: step 0's gradients (each
    reduced by ``ShardPlan.reduce_grads_`` and gathered whole), the widths
    of the (B, S, C) tensors ``linear_scan`` saw, the gather steps of the
    RG-LRU leaves, and one step's collectives.  Returns (the JSON part,
    the flat gradients)."""
    import torch

    from repro_torch.models import rglru
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import activate, gather_tree
    from repro_torch.training.optim import tree_leaves

    cfg, tc, _, _ = tp_case(name)
    mt, params, batch = _placed(cfg, tc, mesh)
    widths, scan = [], rglru.linear_scan

    def spy(a, b, *args, **kw):
        widths.append(a.shape[-1])
        return scan(a, b, *args, **kw)

    rglru.linear_scan = spy
    try:
        with activate(mt.plan):
            grads = list(torch.autograd.grad(loss_fn(params, batch, cfg),
                                             tree_leaves(params)))
            mt.plan.reduce_grads_(grads)
    finally:
        rglru.linear_scan = scan
    it = iter(grads)
    whole = gather_tree(_like(params, it), mt.specs, mesh)
    rec = {"/".join(leaf.path): [list(st) for st in leaf.steps]
           for leaf in mt.plan.leaves if leaf.path[2:3] == ("attn",)
           and leaf.path[1] in mt.plan.channel_stages}
    return ({"scan_widths": widths, "rglru_steps": rec,
             "local": sorted("/".join(leaf.path) for leaf in mt.plan.leaves
                             if leaf.local),
             "collectives": one_step_collectives(cfg, tc, mesh)},
            flat(whole))


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    return next(it)


def ring_run(mesh, world, rank):
    """The ``ring`` job: (rank 0's arrays, this rank's gradients)."""
    import torch

    from repro_torch.models.ring_attention import (ring_attention_shards,
                                                   ring_attention_sharded)

    saved, mine = {}, {}
    for i, (S, Hq, Hkv, causal) in enumerate(RING_CASES):
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in ring_inputs(S, Hq, Hkv))
        dout = torch.from_numpy(ring_dout(S, Hq, Hkv))
        out = ring_attention_sharded(q, k, v, mesh, causal=causal)
        out.backward(dout)
        saved[f"ring{i}"] = out.detach().numpy()
        for name, t in zip(("dq", "dk", "dv"), (q, k, v)):
            mine[f"{name}{i}"] = t.grad.numpy()
        q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
        shards = ring_attention_shards(q2, k2, v2, world, causal=causal)
        shards.backward(dout)
        saved[f"shards{i}"] = shards.detach().numpy()
        for name, t in zip(("dq", "dk", "dv"), (q2, k2, v2)):
            saved[f"shards_{name}{i}"] = t.grad.numpy()
    return saved, mine


def main(job, rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_ranks, make_host_mesh

    torch.set_num_threads(1)
    assert join_ranks(store, rank, world, device="cpu") == "gloo"
    try:
        if job.startswith("serve_tp"):
            arrays, results = {}, {}
            for name in SERVE_CASES:
                _, (data, model) = serve_case(name)
                if data * model != world:
                    continue
                got, results[name] = serve_run(
                    name, make_host_mesh(model=model, device="cpu"))
                arrays.update({f"{name}/{k}": v for k, v in got.items()})
            np.savez(f"{out}.rank{rank}.npz", **arrays)
            with open(f"{out}.rank{rank}.json", "w") as f:
                json.dump(results, f)
            return
        if job.startswith("tp"):
            results = {name: tp_run(name, world, out, rank)
                       for name, (_, (data, model), _, _) in TP_CASES.items()
                       if data * model == world}
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(results, f)
            return
        if job == "channels":
            results = {}
            for name in CHANNEL_CASES:
                _, _, (data, model), _ = tp_case(name)
                if data * model != world:
                    continue
                results[name], grads = channel_run(
                    name, make_host_mesh(model=model, device="cpu"))
                if rank == 0:
                    np.savez(f"{out}.{name}.grads.npz", **grads)
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(results, f)
            return
        mesh = make_host_mesh(model=world if job == "train_model_axis"
                              else 1, device="cpu")
        if job == "ring":
            saved, mine = ring_run(mesh, world, rank)
            np.savez(f"{out}.rank{rank}.npz", **mine)
            if rank == 0:
                with open(out, "wb") as f:
                    np.savez(f, **saved)
        elif job in ("train", "train_model_axis"):
            from repro_torch.training import train

            cfg, tc = train_config()
            _, losses = train(cfg, tc, mesh=mesh, log=lambda m: None,
                              device="cpu")
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(losses, f)
        elif job == "train_moe":
            from repro_torch.training import train

            cfg, tc = moe_config()
            _, losses = train(cfg, tc, mesh=mesh, log=lambda m: None,
                              device="cpu")
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(losses, f)
        else:
            raise SystemExit(f"unknown job {job!r}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
