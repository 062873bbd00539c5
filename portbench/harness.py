"""One run of one cell: the program's serving engine under an open loop on
the wall clock, its metrics, and the check of its served tokens.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``
and ``metrics/<name before the first dot>.py`` (a ``read(rec)`` that
returns the metric's value or None).  ``BENCHMARK.json`` at the checkout's
root names the cells and which metrics each reports.

The run (``run_cell``):

1. weights from the seed on the card (``weights.py``); a throwaway
   engine on them serves two requests, so the kernels are built and the
   libraries loaded before anything is timed; the cost model, MoPE and
   Equinox, the engine (``repro_torch.serving.engine``);
2. the mix's schedule from the seed: arrivals due on the wall clock,
   prompt token ids drawn from the seed;
3. the open loop: before each ``step`` every request whose due time has
   passed is submitted and the engine's clock advanced to the wall
   clock; after it each new output token of every request is stamped on
   the wall clock (a token regenerated after a preemption keeps its
   first stamp).  The ramp (``ramp_s``) is set-up; the window follows
   it; a mix with ``drain_first_tokens`` keeps stepping after the window
   until every request due in it has its first token (at most
   ``DRAIN_LIMIT_S``), submitting nothing new;
4. with ``trace``: ``torch.profiler`` over a slice of the window
   (device activity only) and the harness's own spans around the
   engine's scheduling, model step and lifecycle calls;
5. the engine's state freed, the served tokens of a sample of finished
   requests held against the float32 reference (``reference/``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRAIN_LIMIT_S = 60.0
TRACE_SLICE_S = 6.0          # longest profiled slice of the window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# what a run records: what the metric readers read
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReqLog:
    rid: int
    client: str
    due: float
    prompt_len: int
    output_len: int
    submitted: Optional[float] = None
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: Optional[float] = None
    gen: int = 0                   # generated count last seen
    prefilled: int = 0             # prompt tokens prefilled at least once


@dataclasses.dataclass
class IterLog:
    t0: float                      # wall seconds since the schedule began
    t1: float
    model_s: Optional[float]       # the engine's iter_log entry
    prefill_rows: int
    decode_rows: int
    chunks: List[Tuple[int, int]]  # (start, rows) of each prompt chunk
    decode_ctx: List[int]          # keys each decode row attends
    first_tokens: int              # chunks that completed their prompt
    slot_ctx: Optional[List[int]] = None  # slots backend, traced: every
    #                                       slot's keys in the decode call
    profiled: bool = False
    kv_pages: Optional[int] = None  # paged: pool pages held after the step


@dataclasses.dataclass
class TraceLog:
    t0: float                      # the profiled slice, wall seconds
    t1: float
    kernels: List[Tuple[str, float, float]]   # device activity (name, s, e)
    spans: List[Tuple[str, float, float]]     # the harness's host spans


@dataclasses.dataclass
class Record:
    model: dict
    engine: dict
    window: Tuple[float, float]
    setup_s: float
    clients: List[str]
    requests: List[ReqLog]
    iters: List[IterLog]
    credits: List[Tuple[float, str, int]]     # (t, client, prompt tokens)
    trace: Optional[TraceLog] = None
    kv_pool_pages: Optional[int] = None       # paged: the pool's pages

    def in_window(self, t0, t1=None):
        w0, w1 = self.window
        return w0 <= t0 and (t1 if t1 is not None else t0) <= w1


# ---------------------------------------------------------------------------
# finding a cell's files
# ---------------------------------------------------------------------------
def manifest(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, root=ROOT):
    """(cell, config entry, config file, traffic mix) of the cell
    ``name``."""
    root = pathlib.Path(root)
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return cell, entry, config, mix


def cell_metrics(name: str, kind: str, root=ROOT) -> List[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``):
    those whose ``workloads`` list it; a per-layer metric without the
    list, in every cell that reports the end-to-end metric it moves."""
    man = manifest(root)
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(metric: str, root=ROOT):
    """``metrics/<name before the first dot>.py``'s ``read``."""
    path = pathlib.Path(root) / "portbench" / "metrics" \
        / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config):
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------
def build_cfg(config):
    """The program's registered configuration with the file's overrides,
    checked against the file's ``model`` block key by key."""
    from repro_torch.configs import get_config
    cfg = get_config(config["arch"])
    for key, val in config.get("overrides", {}).items():
        if key.startswith("moe."):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **{key[4:]: val}))
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    wrong = []
    for key, want in config["model"].items():
        if key == "moe":
            for k, v in want.items():
                if getattr(cfg.moe, k) != v:
                    wrong.append((f"moe.{k}", getattr(cfg.moe, k), v))
            continue
        got = cfg.resolved_head_dim() if key == "head_dim" \
            else getattr(cfg, key)
        if got != want:
            wrong.append((key, got, want))
    if wrong:
        raise SystemExit(f"{config['arch']}: the program's configuration "
                         f"differs from the file: {wrong}")
    return cfg


def warm_up(config, cfg, params, device):
    """Build the kernels and initialise the libraries before the schedule
    starts: a throwaway engine on the same weights (FCFS, four slots, a
    small KV budget) serves a prompt longer than the chunk budget and a
    short one to completion."""
    from repro_torch.core import make_scheduler
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import ServingEngine
    kw = dict(config["engine"], max_slots=4,
              kv_budget_tokens=4 * config["engine"]["max_len"])
    eng = ServingEngine(cfg, make_scheduler("fcfs"), params=params,
                        device=device, seed=0, **kw)
    n = kw["prefill_chunk_tokens"] + 17
    for rid, plen in enumerate((min(n, kw["max_len"] - 8), 33)):
        req = Request(rid=rid, client="warm-up", arrival=0.0,
                      prompt_len=plen, output_len=4)
        req.prompt_tokens = np.arange(plen, dtype=np.int32) % 1000
        eng.submit(req)
    while eng.has_work():
        eng.step()
    free_engine(eng)


def build_engine(config, cfg, params, device):
    from repro_torch.core import make_scheduler
    from repro_torch.predictor import MoPE
    from repro_torch.serving import costmodel
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.workloads import corpus
    cm = costmodel.CostModel(cfg, getattr(costmodel, config["cost_model"]))
    if config["predictor"] != "mope":
        raise ValueError(f"unknown predictor {config['predictor']!r}")
    pred = MoPE(cm, corpus(8000, seed=0), epochs=20)
    sched = make_scheduler(config["scheduler"], predictor=pred)
    return ServingEngine(cfg, sched, params=params, cost_model=cm,
                         device=device, seed=0, **config["engine"])


# ---------------------------------------------------------------------------
# the open loop
# ---------------------------------------------------------------------------
class _Spans:
    """The harness's host spans around the engine's calls, recorded while
    ``on``: (name, start, end) in wall seconds since the schedule began."""

    def __init__(self, origin):
        self.origin, self.on, self.spans = origin, False, []

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0 - self.origin,
                                   time.perf_counter() - self.origin))
        setattr(obj, attr, wrapped)


def _watch_plans(eng):
    """Wrap ``BatchCore.plan_prefill`` on this engine: each iteration's
    plan and the decode rows beside it, as the engine is about to run
    them."""
    seen = {}
    core = eng.core
    plan_prefill = core.plan_prefill

    def wrapped(running):
        plan = plan_prefill(running)
        seen["plan"] = [(r, c) for r, c in plan]
        seen["decode"] = [r._pos + 1 for r in running
                          if r.state == "decoding"]
        return plan
    core.plan_prefill = wrapped
    return seen


def open_loop(eng, arrivals, mix, seconds, seed, vocab, trace=False,
              t_process=None):
    """Drive the engine (module docstring); returns the Record's pieces
    and the profiler's slice."""
    import torch
    from portbench.traffic.generator import prompt_tokens
    from repro_torch.core.request import Request

    ramp = float(mix["ramp_s"])
    w0, w1 = ramp, ramp + float(seconds)
    drain = bool(mix.get("drain_first_tokens"))
    tokens = {a.rid: prompt_tokens(seed, a.rid, a.prompt_len, vocab)
              for a in arrivals}
    logs = {a.rid: ReqLog(a.rid, a.client, a.due, a.prompt_len,
                          a.output_len) for a in arrivals}
    reqs: Dict[int, object] = {}
    seen = _watch_plans(eng)
    iters: List[IterLog] = []
    credits = []
    origin = time.perf_counter()
    spans = _Spans(origin)
    prof = None
    # the profiled slice closes the window, so the profiler's processing
    # after it delays nothing the window measures
    slice0 = w1 - min(TRACE_SLICE_S, 0.5 * (w1 - w0))
    trace_log = None
    if trace:
        for obj, attr, name in ((eng.core, "admit", "schedule"),
                                (eng.core, "prepare_iteration", "schedule"),
                                (eng.core, "plan_prefill", "schedule"),
                                (eng, "_run_mixed_paged", "model_step"),
                                (eng, "_run_prefill", "model_step"),
                                (eng, "_decode", "model_step"),
                                (eng.core, "execute_iteration", "lifecycle"),
                                (eng, "step", "step")):
            spans.wrap(obj, attr, name)
    pool = getattr(eng, "pool", None)     # the paged backend's pages
    nxt = 0
    setup_s = None
    while True:
        now = time.perf_counter() - origin
        if setup_s is None and now >= w0:
            setup_s = time.perf_counter() - t_process
        if trace and prof is None and now >= slice0:
            prof, marker = _start_profiler(torch)
            spans.on = True
            t_prof0 = time.perf_counter() - origin
        if prof is not None and trace_log is None and now >= w1:
            torch.cuda.synchronize()
            t_prof1 = time.perf_counter() - origin
            spans.on = False
            prof.stop()
            trace_log = TraceLog(t_prof0, t_prof1,
                                 _device_events(prof, marker, origin),
                                 spans.spans)
        # every arrival due by now and inside the window; none after it
        while nxt < len(arrivals) and arrivals[nxt].due <= now \
                and arrivals[nxt].due < w1:
            a = arrivals[nxt]
            req = Request(rid=a.rid, client=a.client, arrival=a.due,
                          prompt_len=a.prompt_len, output_len=a.output_len,
                          keywords=a.keywords)
            req.prompt_tokens = tokens[a.rid]
            eng.submit(req)
            reqs[a.rid] = req
            logs[a.rid].submitted = now
            nxt += 1
        if now >= w1 and (not drain or all(
                logs[r].stamps for r in reqs
                if w0 <= logs[r].due) or now >= w1 + DRAIN_LIMIT_S):
            break
        eng.advance_to(now)
        if not eng.has_work():
            time.sleep(0.0005)
            continue
        before = list(eng.running)
        n_fin, n_log = len(eng.finished), len(eng.iter_log)
        seen.clear()
        slot_ctx = None
        if trace_log is None and prof is not None \
                and eng.backend == "slots":
            # the decode call's keys for every slot, active or not
            slot_ctx = [min(int(p) + 1, eng.max_len)
                        for p in eng.cache["pos"].tolist()]
        t0 = time.perf_counter() - origin
        eng.step()
        t1 = time.perf_counter() - origin
        model = eng.iter_log[n_log] if len(eng.iter_log) > n_log else None
        plan = seen.get("plan", [])
        chunks = [(r.prefill_done - c, c) for r, c in plan]
        for r, c in plan:
            log = logs[r.rid]
            if r.prefill_done > log.prefilled:
                credits.append((t1, log.client,
                                r.prefill_done - log.prefilled))
                log.prefilled = r.prefill_done
        firsts = sum(1 for r, _ in plan if r.prefill_done >= r.prompt_len)
        iters.append(IterLog(
            t0, t1, model[0] if model else None,
            model[1] if model else 0, model[2] if model else 0,
            chunks, seen.get("decode", []), firsts, slot_ctx,
            profiled=prof is not None and trace_log is None,
            kv_pages=None if pool is None
            else pool.n_pages - len(pool.free)))
        for r in {id(r): r for r in before + eng.running
                  + eng.finished[n_fin:]}.values():
            _stamp(logs[r.rid], r, t1)
        for r in eng.finished[n_fin:]:
            logs[r.rid].finished = t1
    if setup_s is None:
        setup_s = time.perf_counter() - t_process
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return (w0, w1), setup_s, list(logs.values()), iters, credits, \
        trace_log, reqs, tokens


def _stamp(log: ReqLog, req, t):
    """Record the token a step produced for ``req``, if any."""
    gen = req.generated
    if gen > log.gen:
        i = gen - 1
        if i < len(log.stamps):          # regenerated after a preemption
            log.tokens[i] = int(req._next_token)
        else:
            log.stamps.append(t)
            log.tokens.append(int(req._next_token))
    log.gen = gen


# ---------------------------------------------------------------------------
# the traced slice
# ---------------------------------------------------------------------------
def _start_profiler(torch):
    """Start a device-only profiler and launch a marker kernel at a known
    host time, which ties the device timeline to the host's."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    host = time.perf_counter()
    torch.cuda._sleep(2000)
    torch.cuda.synchronize()
    return prof, host


def _device_events(prof, marker_host, origin):
    """Device activity (kernels, copies, sets) as (name, start, end) in
    wall seconds since the schedule began, aligned by the marker."""
    from torch.autograd import DeviceType
    raw = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") \
            else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") \
            else e.duration_us() * 1000
        raw.append((e.name(), start, start + dur))
    if not raw:
        return []
    marks = [s for n, s, _ in raw if "spin" in n.lower()
             or "sleep" in n.lower()]
    first = min(marks) if marks else min(s for _, s, _ in raw)
    shift = (marker_host - origin) - first * 1e-9
    return [(n, s * 1e-9 + shift, e * 1e-9 + shift) for n, s, e in raw
            if not ("spin" in n.lower() or "sleep" in n.lower())]


def busy_intervals(kernels, t0, t1):
    """The union of device activity inside [t0, t1], merged."""
    iv = sorted((max(s, t0), min(e, t1)) for _, s, e in kernels
                if e > t0 and s < t1)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(trace: TraceLog):
    """[(host span, seconds)]: every stretch of the slice with nothing on
    the device, named by the innermost harness span covering its middle
    ("harness" outside the engine's calls)."""
    busy = busy_intervals(trace.kernels, trace.t0, trace.t1)
    edges = [trace.t0] + [x for iv in busy for x in iv] + [trace.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = [(ss, n) for n, ss, ee in trace.spans if ss <= mid <= ee]
        out.append((max(cover)[1] if cover else "harness", e - s))
    return out


def breakdown(trace: TraceLog):
    """The ten device operations that took most time and the ten longest
    idle gaps, by what the host was doing."""
    by_name: Dict[str, float] = {}
    for n, s, e in trace.kernels:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(trace), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


# ---------------------------------------------------------------------------
# the check of the served tokens
# ---------------------------------------------------------------------------
def compared_positions(n, cap):
    """The served tokens of a request of ``n`` that are compared: all of
    them, or ``cap`` spread evenly from the first to the last."""
    if n <= cap:
        return np.arange(n)
    return np.unique(np.linspace(0, n - 1, cap).round().astype(np.int64))


def sample(logs: List[ReqLog], mix, window, seed):
    """Finished requests of the window (and its drain), drawn from the
    seed: the longest first, then one request of each client in turn (the
    clients, and each client's requests, in orders drawn from the seed),
    until at least ``min_requests`` requests and ``min_tokens`` compared
    tokens, or ``max_requests`` requests; a request that would take the
    tokens through the reference past ``max_ref_tokens`` is passed over.
    A request compares at most ``tokens_per_request`` of its served
    tokens (``compared_positions``), so no one request fills the
    sample."""
    spec = mix["sample"]
    cap = spec["tokens_per_request"]
    done = [lg for lg in logs if lg.finished is not None
            and lg.finished >= window[0]
            and len(lg.tokens) == lg.output_len > 0]
    if not done:
        return []
    rng = np.random.default_rng([seed, 7])
    longest = max(done, key=lambda lg: (lg.output_len, lg.rid))
    queues: Dict[str, List[ReqLog]] = {}
    for i in rng.permutation(len(done)):
        if done[i] is not longest:
            queues.setdefault(done[i].client, []).append(done[i])
    clients = sorted(queues)
    turns = [queues[clients[i]] for i in rng.permutation(len(clients))]
    out, compared, through = [], 0, 0

    def enough():
        return len(out) >= spec["max_requests"] or (
            len(out) >= spec["min_requests"]
            and compared >= spec["min_tokens"])

    order = [longest]
    while any(turns):
        order += [q.pop(0) for q in turns if q]
    for lg in order:
        cost = lg.prompt_len + lg.output_len
        if out and through + cost > spec["max_ref_tokens"]:
            continue
        out.append(lg)
        compared += min(lg.output_len, cap)
        through += cost
        if enough():
            break
    return out


def served_gaps(params, config, picked, prompts, device, cap, fp8=False,
                **variant):
    """Per sampled request, the f32 reference's logits at the position of
    each compared served token (``compared_positions`` with ``cap``),
    held against the served token: (gaps of the served tokens, and with
    ``fp8`` the gaps of the tokens the fp8 control puts first).
    ``variant``: keywords of the family's reference for a second reading
    in the control's place (its first tokens' gaps)."""
    import torch
    ref = reference_module(config)
    seqs, wants, served = [], [], []
    for lg in picked:
        p = np.asarray(prompts[lg.rid], np.int64)
        toks = np.asarray(lg.tokens, np.int64)
        at = compared_positions(len(toks), cap)
        seqs.append(torch.from_numpy(np.concatenate([p, toks[:at[-1]]])))
        wants.append(torch.from_numpy(len(p) - 1 + at))
        served.append(torch.from_numpy(toks[at]))
    rows = ref.logits(params, config["model"], seqs, wants, device=device)
    gaps = [(r.max(-1).values - r.gather(-1, s.to(r.device)[:, None])[:, 0])
            for r, s in zip(rows, served)]
    ctrl = None
    if fp8 or variant:
        low = ref.logits(params, config["model"], seqs, wants, fp8=fp8,
                         device=device, **variant)
        ctrl = [(r.max(-1).values - r.gather(-1, c.argmax(-1)[:, None])[:, 0])
                for r, c in zip(rows, low)]
    return gaps, ctrl


GAP_STATS = {"max_logit_gap": lambda g: float(g.max()),
             "mean_logit_gap": lambda g: float(g.mean())}


def check(gaps, config):
    """The numbers compared, each with its limit (those of ``GAP_STATS``
    that the configuration's ``limits`` name, and the tokens compared),
    and whether all hold."""
    import torch
    lim = config["limits"]
    g = torch.cat([x.float().cpu() for x in gaps]) if gaps \
        else torch.full((1,), float("inf"))
    checks = {}
    for name, stat in GAP_STATS.items():
        if name in lim:
            checks[name] = {"value": stat(g), "limit": lim[name]}
    n = int(sum(len(x) for x in gaps))
    ok = all(c["value"] <= c["limit"] for c in checks.values()) \
        and n >= lim["min_tokens_compared"]
    checks["tokens_compared"] = {"value": n,
                                 "limit": lim["min_tokens_compared"]}
    return ok, checks


def free_engine(eng):
    """Drop the engine's pools, caches and requests' partial caches."""
    import torch
    for name in ("k_pools", "v_pools", "k_scales", "v_scales", "cache"):
        if hasattr(eng, name):
            setattr(eng, name, None)
    for r in list(eng.running):
        r._pcache = None
    eng.running.clear()
    gc.collect()
    torch.cuda.empty_cache()


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run_cell(name, seed, seconds, trace, t_process, device="cuda",
             root=ROOT, control=False, engine=None, variant=None):
    """Run the cell; returns (result dict, run facts for standard error).
    ``control`` (``control.py``): also the fp8 control's gaps on the same
    sample, or with ``variant`` those of the reference with these
    keywords; ``engine``: engine keywords over the configuration's (the
    program's int8 pages)."""
    import torch
    from portbench.traffic.generator import schedule
    from portbench.weights import make_params

    cell, _, config, mix = load_cell(name, root)
    config["engine"].update(engine or {})
    cfg = build_cfg(config)
    params = make_params(config["model"], seed, device)
    warm_up(config, cfg, params, device)
    eng = build_engine(config, cfg, params, device)
    ramp = float(mix["ramp_s"])
    arrivals = schedule(mix, seed, ramp + float(seconds))
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    window, setup_s, logs, iters, credits, tlog, reqs, prompts = open_loop(
        eng, arrivals, mix, seconds, seed, config["model"]["vocab_size"],
        trace=trace, t_process=t_process)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or of the JAX package were "
                         f"loaded: {bad}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    clients = sorted({a.client for a in arrivals})
    pool = getattr(eng, "pool", None)
    rec = Record(config["model"], config["engine"], window, setup_s,
                 clients, logs, iters, credits, tlog,
                 None if pool is None else pool.n_pages)
    due = [lg for lg in logs if window[0] <= lg.due < window[1]]
    drain = bool(mix.get("drain_first_tokens"))
    failed = sum(1 for lg in due if not lg.stamps) if drain else 0
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(name, kind, root):
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    free_engine(eng)
    del eng, reqs
    picked = sample(logs, mix, window, seed)
    t_ref = time.perf_counter()
    gaps, ctrl = served_gaps(params, config, picked, prompts, device,
                             fp8=control and not variant,
                             cap=mix["sample"]["tokens_per_request"],
                             **(variant or {})) \
        if picked else ([], None)
    t_ref = time.perf_counter() - t_ref
    ok, checks = check(gaps, config)
    result = {"correct": bool(ok), "attempted": len(due), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": torch.cuda.get_device_name(0)
                         if device != "cpu" else "cpu",
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace and tlog is not None:
        busy = busy_intervals(tlog.kernels, tlog.t0, tlog.t1)
        result["device"]["busy_s"] = float(sum(e - s for s, e in busy))
        result["device"]["window_s"] = float(tlog.t1 - tlog.t0)
        result["breakdown"] = breakdown(tlog)
    result["checks"] = checks
    info = {"requests_due_in_window": len(due),
            "sampled_requests": [lg.rid for lg in picked],
            "sampled_clients": len({lg.client for lg in picked}),
            "sampled_due_in_window": sum(1 for lg in picked
                                         if window[0] <= lg.due < window[1]),
            "reference_s": t_ref,
            "iterations_in_window": sum(1 for it in iters
                                        if rec.in_window(it.t0, it.t1)),
            "waiting_at_end": sum(1 for lg in logs if lg.submitted is not None
                                  and not lg.stamps),
            "late_submit_s_max": max((lg.submitted - lg.due for lg in logs
                                      if lg.submitted is not None),
                                     default=0.0)}
    kv = [it.kv_pages for it in iters if it.kv_pages is not None
          and rec.in_window(it.t0, it.t1)]
    if kv:
        page = config["engine"]["page_size"]
        info["kv_tokens_in_use"] = {"mean": page * sum(kv) / len(kv),
                                    "max": page * max(kv),
                                    "pool": page * rec.kv_pool_pages}
    if gaps:
        info["gap_stats"] = gap_stats(gaps)
    if ctrl is not None:
        info["control_gap_stats"] = gap_stats(ctrl)
        info["control_correct"], info["control_checks"] = check(ctrl, config)
    return result, info


def gap_stats(gaps):
    """The spread of served-token gaps: max, 99th percentile, mean, the
    share of tokens that are not the reference's first, and the five
    largest."""
    import torch
    g = torch.cat([x.float().cpu() for x in gaps])
    return {"max": float(g.max()), "p99": float(torch.quantile(g, 0.99)),
            "mean": float(g.mean()), "share_nonzero": float((g > 0).float()
                                                           .mean()),
            "top5": [float(x) for x in torch.topk(g, min(5, len(g)))[0]]}
