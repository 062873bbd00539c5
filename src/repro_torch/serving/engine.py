"""Continuous-batching serving engine running a PyTorch model on the card.

Port of ``repro/serving/engine.py`` for ``backend="paged"`` with
stall-free chunked prefill, the paper's Llama-2 testbed path: paged KV
pools on the device and the hand-written CUDA paged-attention kernels
(``repro_torch.kernels``).  Every iteration's prefill-chunk rows and
decode rows go down in one ragged ``_paged_decode_step`` call.

Timing uses a dual clock: wall-clock for real measurements
(``iter_log``: each iteration's model step) and the analytic cost model for target-hardware metrics
fed back to the scheduler.  Scheduling decisions (admission,
``canSchedule`` KV reservation, the chunked-prefill plan, the completion
feedback loop) are not re-implemented here: the engine drives the same
``BatchCore`` as the reference (DESIGN.md §6), so the two make the same
decisions.  A request's first token is stamped after the modeled clock
has advanced over the iteration that ran its last chunk.  The engine
exposes the replica protocol (``submit``/``step``/``clock``/``has_work``/
``advance_to``) of the cluster layer (DESIGN.md §7).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``
(the tests); on the CPU the kernels' plain versions run instead.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.request import DECODING, Request
from repro_torch.core.schedulers import SchedulerBase
from repro_torch.kernels import paged_attention
from repro_torch.models.attention import quantize_kv
from repro_torch.models.layers import (apply_rope, dtype_of, embed, mlp,
                                       rmsnorm, unembed)
from repro_torch.serving.batch_core import BatchConfig, BatchCore
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.kv_cache import PagePool, make_pools
from repro_torch.weights import init_params, resolve_device


def _next_pow2(n: int) -> int:
    """Shape bucketing for the decode step (DESIGN.md §16): row counts and
    table widths round up to powers of two, bounding the set of shapes."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ServingEngine:
    def __init__(self, cfg: ModelConfig, scheduler: SchedulerBase, *,
                 params=None, max_slots: int = 8, max_len: int = 512,
                 kv_budget_tokens: Optional[int] = None,
                 cost_model: Optional[CostModel] = None,
                 backend: str = "paged", page_size: int = 16,
                 seed: int = 0, sample_temp: float = 0.0,
                 chunked: bool = True,
                 prefill_chunk_tokens: int = 512,
                 target_iter_time: float = 0.25,
                 slo_budget: str = "static",
                 prefix_cache: bool = False,
                 kv_quant: bool = False,
                 keep_first_logits: bool = False,
                 observer=None, admission=None, device=None):
        if backend != "paged" or not chunked:
            raise NotImplementedError(
                "only backend='paged' with chunked prefill is ported; the "
                "slots backend and whole-prompt prefill are ROADMAP.md "
                "Queue A item 6")
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache is ROADMAP.md Queue A item 11")
        if cfg.moe is not None:
            raise NotImplementedError(
                "MoE stacks on the paged step are ROADMAP.md Queue A item 6")
        if set(cfg.layer_kinds()) != {ATTN} or cfg.is_encoder_decoder:
            raise ValueError("paged backend supports uniform dense-GQA "
                             "stacks")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sched = scheduler
        self.max_slots = max_slots
        self.max_len = max_len
        # debug/test probe: retain each request's first-token logits row
        self.keep_first_logits = keep_first_logits
        self.cm = cost_model or CostModel(cfg)
        self.kv_quant = kv_quant
        self.core = BatchCore(
            scheduler, self.cm,
            BatchConfig(max_batch=max_slots,
                        kv_budget_tokens=kv_budget_tokens
                        # int8 pages halve KV bytes/token, so the same
                        # physical memory holds ~2x the token budget
                        or max_slots * max_len * (2 if kv_quant else 1),
                        kv_quant=kv_quant,
                        default_reserve=128,      # engine's legacy reserve
                        prefill_chunk=prefill_chunk_tokens,
                        target_iter_time=target_iter_time,
                        slo_budget=slo_budget,
                        adaptive_batching=True,
                        stall_free=True,
                        # page-rounded KV accounting (DESIGN.md §10):
                        # budget respected => pool never physically
                        # exhausts
                        kv_page_size=page_size),
            observer=observer, admission=admission)
        self.kv_budget = self.core.kv_budget
        self.sample_temp = sample_temp
        # temperature sampling draws on the host, from this generator only
        self.gen = torch.Generator().manual_seed(seed)
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=self.device).manual_seed(seed + 1),
                self.device)
        self.params = params
        n_pages = -(-self.kv_budget // page_size)
        self.pool = PagePool(n_pages, page_size)
        # the device pools carry one extra sacrificial page at index
        # n_pages, invisible to the allocator: the ragged launch pads its
        # row count to a power of two and every padding row writes to
        # (and attends over) this scratch page, never a live request's
        self._scratch_page = n_pages
        self.k_scales = self.v_scales = None
        if kv_quant:
            (self.k_pools, self.v_pools, self.k_scales,
             self.v_scales) = make_pools(
                cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                cfg.resolved_head_dim(), quantized=True, device=self.device)
        else:
            self.k_pools, self.v_pools = make_pools(
                cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                cfg.resolved_head_dim(), dtype_of(cfg), device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.running = self.core.running    # alias: core owns the batch
        self.reserved = self.core.reserved  # alias: core owns KV accounting
        self.t_model = 0.0            # modeled target-hardware clock
        # wall clock of each iteration's model step and its copy back,
        # without the host's scheduling work: (seconds, chunk rows,
        # decode rows)
        self.iter_log: List[Tuple[float, int, int]] = []
        self.finished: List[Request] = []
        self.iterations = 0

    # -- helpers ----------------------------------------------------------------
    def now(self) -> float:
        return self.t_model

    # replica protocol (cluster layer) ------------------------------------------
    @property
    def clock(self) -> float:
        return self.t_model

    def advance_to(self, t: float):
        self.t_model = max(self.t_model, t)

    def has_work(self) -> bool:
        return bool(self.running) or self.sched.has_waiting()

    @property
    def n_finished(self) -> int:
        return len(self.finished)

    @property
    def n_preemptions(self) -> int:
        """Preemption events on this replica (cluster metric)."""
        return self.core.n_preemptions

    def kv_load(self) -> float:
        return self.core.kv_load()

    def queued_prompt_tokens(self) -> int:
        return self.core.queued_prompt_tokens()

    def _free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def submit(self, req: Request):
        # overload-aware admission gate (DESIGN.md §13)
        if not self.core.accept(req, self.now()):
            return
        if req.prompt_tokens is None:
            req.prompt_tokens = np.random.default_rng(req.rid).integers(
                0, self.cfg.vocab_size, req.prompt_len).astype(np.int32)
        elif len(req.prompt_tokens) > req.prompt_len:
            # workload post-capped prompt_len: the model input must agree
            # on the prompt's extent
            req.prompt_tokens = req.prompt_tokens[:req.prompt_len]
        self.sched.on_arrival(req, self.now())

    def _bind_slot(self, req: Request, slot: int):
        """Admission bookkeeping only — no model work happens here.  The
        prompt runs later through the shared chunk plan."""
        req._slot = slot
        req._pos = 0
        self.slots[slot] = req
        self.running.append(req)

    def _drop_backend_state(self, req: Request):
        """Preemption (DESIGN.md §10): free the victim's pool pages and
        vacate its slot.  The recompute path rebuilds everything at
        re-admission."""
        self.pool.release_request(req.rid)
        slot = getattr(req, "_slot", None)
        if slot is not None and self.slots[slot] is req:
            self.slots[slot] = None
        req._slot = None

    def _run_mixed_paged(self, plan, decoding: List[Request]):
        """The fused mixed iteration (DESIGN.md §16): every planned
        prefill-chunk token and every decode row of this iteration goes
        down in ONE ``_paged_decode_step`` call, a ragged launch where row
        r writes its K/V at position ``ctx[r]`` of request ``row_map[r]``'s
        pages and attends its causal prefix.  Rows, table rows and table
        width are bucketed to powers of two; padding rows write token 0 at
        pos 0 of the scratch page.  Only the rows the host reads (each
        chunk's last row, each decode row) are brought back.

        Returns ({rid: last-chunk-row logits}, {rid: decode logits})."""
        if not plan and not decoding:
            return {}, {}
        tokens: List[int] = []
        ctx: List[int] = []
        rmap: List[int] = []
        last_row: Dict[int, int] = {}
        for t, (req, chunk) in enumerate(plan):
            start = req.prefill_done - chunk
            self.pool.ensure(req.rid, start + chunk)
            tokens.extend(int(x) for x in
                          req.prompt_tokens[start:start + chunk])
            ctx.extend(range(start, start + chunk))
            rmap.extend([t] * chunk)
            last_row[req.rid] = len(tokens) - 1
        n_chunk_rows = len(tokens)
        for i, r in enumerate(decoding):
            self.pool.extend(r.rid, r._pos, r._pos + 1)
            tokens.append(int(r._next_token))
            ctx.append(r._pos)
            rmap.append(len(plan) + i)
        rids = [req.rid for req, _ in plan] + [r.rid for r in decoding]
        n_t = len(rids)
        # normally pages_needed(max_len), but requests may outgrow max_len
        # (output length is not capped by it), so widen in power-of-two
        # buckets instead of truncating their tables
        width = self.pool.pages_needed(self.max_len)
        for rid in rids:
            width = max(width, len(self.pool.owned.get(rid, ())))
        width = _next_pow2(width)
        n_tab = _next_pow2(n_t + 1)       # >=1 spare row: the scratch page
        bt = np.full((n_tab, width), self._scratch_page, np.int32)
        bt[:n_t] = self.pool.block_table(rids, width)
        n_rows = len(tokens)
        n_pad = _next_pow2(n_rows)
        if n_pad > n_rows:                # padding rows: token 0 at pos 0
            tokens += [0] * (n_pad - n_rows)   # on the scratch page (all
            ctx += [0] * (n_pad - n_rows)      # write identical values);
            rmap += [n_t] * (n_pad - n_rows)   # ctx=0 => fully masked
        read = list(last_row.values()) + [n_chunk_rows + i
                                          for i in range(len(decoding))]

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

        t0 = time.perf_counter()
        logits = _paged_decode_step(
            self.params, dev(tokens), dev(ctx), dev(bt), dev(rmap),
            self.k_pools, self.v_pools, self.k_scales, self.v_scales,
            self.cfg, self.pool.page_size, dev(read))
        logits = logits.cpu().numpy()     # waits for the device
        self.iter_log.append((time.perf_counter() - t0, n_chunk_rows,
                              len(decoding)))
        n_first = len(last_row)
        first_rows = {rid: logits[j] for j, rid in enumerate(last_row)}
        rows = {r.rid: logits[n_first + i] for i, r in enumerate(decoding)}
        return first_rows, rows

    def _install_prefill(self, req: Request, row):
        """Prompt fully prefilled: make the request decodable."""
        req._next_token = int(np.argmax(row))
        if self.keep_first_logits:
            req._first_row = np.asarray(row, np.float32)
        req._pos = req.prompt_len

    def _sample(self, row) -> int:
        if self.sample_temp > 0:
            probs = torch.softmax(torch.from_numpy(
                np.asarray(row, np.float64)) / self.sample_temp, -1)
            return int(torch.multinomial(probs, 1, generator=self.gen))
        return int(np.argmax(row))

    # -- main loop -----------------------------------------------------------------
    def step(self):
        """One continuous-batching iteration (mirrors the reference
        engine's ``step`` statement for statement — both drive the shared
        BatchCore).  Returns #running requests (1 when only quota-blocked
        queued work exists — the clock still advanced), 0 when idle."""
        now = self.now()
        # 1. admission (Algorithm 1 inner loop)
        admitted = self.core.admit(
            now, len(self.running),
            has_capacity=lambda: self._free_slot() >= 0,
            on_admitted=lambda req: self._bind_slot(req,
                                                    self._free_slot()))
        if not self.running:
            if not self.sched.has_waiting():
                return 0
            # quota/window-blocked scheduler (e.g. RPM): run an empty
            # iteration so the modeled clock advances
            self.t_model += self.core.iteration_time([], [], True)
            self.iterations += 1
            return 1

        # 1b. reservation reconciliation + fairness-aware preemption
        #     (DESIGN.md §10), before any model work
        preempted = self.core.prepare_iteration(now, self.running)
        for req in preempted:
            self._drop_backend_state(req)
            self.running.remove(req)

        # 2+3. chunked prefill + batched decode of every request that was
        #    DECODING at iteration start, in ONE ragged launch
        plan = self.core.plan_prefill(self.running)
        decoding = [r for r in self.running if r.state == DECODING]
        first_rows, rows = self._run_mixed_paged(plan, decoding)
        done_prefill = [(req, first_rows[req.rid]) for req, _ in plan
                        if req.prefill_done >= req.prompt_len]

        # 4. modeled clock advance (timing rule shared with the simulator)
        ctxs = [r.prompt_len + r.generated for r in decoding]
        fresh = bool(admitted) or bool(preempted)
        t_iter = self.core.iteration_time(plan, ctxs, fresh)
        self.t_model += t_iter
        now = self.now()

        # 5. lifecycle — the shared iteration body (DESIGN.md §15)
        n_running = len(self.running)
        first_rows = {req.rid: row for req, row in done_prefill}

        def on_first(req):
            self._install_prefill(req, first_rows[req.rid])

        def on_decode(req):
            req._next_token = self._sample(rows[req.rid])
            req._pos += 1

        def post_complete(req):
            self.finished.append(req)
            self.pool.free_request(req.rid)
            self.slots[req._slot] = None

        self.core.execute_iteration(
            now, plan, decoding, t_iter=t_iter, fresh=fresh,
            firsts=[req for req, _ in done_prefill],
            admitted=admitted, preempted=preempted,
            on_first=on_first, on_decode=on_decode,
            post_complete=post_complete)
        self.iterations += 1
        return n_running

    def run(self, requests: List[Request] = None,
            max_iters: int = 1_000_000, interactions=None):
        """Submit everything (arrivals honored on the modeled clock) and
        run to completion; ``interactions`` are released closed-loop as
        in the reference (DESIGN.md §13)."""
        heap: List[tuple] = []        # (arrival, seq, req); seq preserves
        seq = 0                       # submission order on arrival ties

        def push(req):
            nonlocal seq
            heapq.heappush(heap, (req.arrival, seq, req))
            seq += 1

        for r in sorted(requests or [], key=lambda r: r.arrival):
            push(r)
        for inter in interactions or []:
            self.core.register_interaction(inter)
            first = inter.next_request()  # keeps its stamped arrival
            if first is not None:
                push(first)
        self.core.on_turn_release = lambda nxt, now: push(nxt)

        for _ in range(max_iters):
            while heap and heap[0][0] <= self.now():
                self.submit(heapq.heappop(heap)[2])
            n = self.step()
            if n == 0:
                if not heap:
                    break
                self.t_model = max(self.t_model, heap[0][0])
        return self.finished


# ---------------------------------------------------------------------------
# Paged dense-GQA decode step
# ---------------------------------------------------------------------------
@torch.no_grad()
def _paged_decode_step(params, tokens, ctx_lens, block_tables, row_map,
                       k_pools, v_pools, k_scales, v_scales,
                       cfg: ModelConfig, page_size: int, out_rows):
    """The fused ragged mixed-iteration step (DESIGN.md §16).

    tokens/ctx_lens/row_map: (R,) int32 — row r writes its K/V at position
    ctx_lens[r] of table row row_map[r]'s pages, then attends its causal
    prefix (ctx_lens[r]+1 tokens).  block_tables: (T, W) compact
    per-request table.  The pools are written in place (the reference
    returns updated copies); each layer's write is issued before that
    layer's attention on the same stream, because chunk rows attend to
    rows written in the same step.  Padding rows all write slot 0 of the
    scratch page with identical values, so duplicate indices are benign.

    int8 KV pages: when the pools are int8, ``k_scales``/``v_scales`` are
    the per-(slot, head) bf16 scale pools and new tokens are quantized
    with ``quantize_kv`` before the write.  Returns f32 logits of the rows
    ``out_rows`` only."""
    R = tokens.shape[0]
    quant = k_pools.dtype == torch.int8
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    x = embed(params["embed"], tokens).to(dtype_of(cfg))    # (R, d)
    pos = ctx_lens
    stage = params["stages"]["stage_0"]
    attn, ffn = stage["attn"], stage["ffn"]
    my_table = block_tables[row_map.long()]                 # (R, W)
    page_idx = my_table[torch.arange(R, device=tokens.device),
                        (pos // page_size).long()].long()
    slot_idx = (pos % page_size).long()
    ctx_attn = pos + 1
    for i in range(cfg.n_layers):
        h = rmsnorm({"scale": stage["ln1"]["scale"][i]}, x, cfg.norm_eps)
        q = (h @ attn["wq"][i].reshape(h.shape[-1], H * hd)).reshape(R, H, hd)
        k = (h @ attn["wk"][i].reshape(h.shape[-1], Hkv * hd)).reshape(
            R, Hkv, hd)
        v = (h @ attn["wv"][i].reshape(h.shape[-1], Hkv * hd)).reshape(
            R, Hkv, hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        ks = vs = None
        if quant:
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            ks, vs = k_scales[i], v_scales[i]
            ks[page_idx, slot_idx] = k_s                    # in place
            vs[page_idx, slot_idx] = v_s                    # in place
        kp, vp = k_pools[i], v_pools[i]
        kp[page_idx, slot_idx] = k                          # in place
        vp[page_idx, slot_idx] = v                          # in place
        out = paged_attention(q, kp, vp, block_tables, ctx_attn,
                              row_map=row_map, k_scale=ks, v_scale=vs)
        x = x + out.reshape(R, H * hd) @ attn["wo"][i].reshape(H * hd, -1)
        h2 = rmsnorm({"scale": stage["ln2"]["scale"][i]}, x, cfg.norm_eps)
        x = x + mlp({k_: w[i] for k_, w in ffn.items()}, h2, cfg.act)
    x = rmsnorm(params["final_norm"], x[out_rows.long()], cfg.norm_eps)
    return unembed(params["embed"], x).float()
