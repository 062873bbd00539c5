"""Continuous-batching serving engine running a PyTorch model on the card.

Port of ``repro/serving/engine.py``.  Two decode backends, as in the
reference:

- ``slots`` (the default): per-slot contiguous caches through
  ``models.decode_step`` with per-request positions, for attention stacks
  (full or sliding-window, whose slot caches are rings; dense or MoE
  FFNs) and Mamba-2 stacks.  Prompts run whole (``models.prefill``: the flash
  attention kernel or the SSD-scan kernel, one launch per layer) or, for
  stacks that ``supports_chunked_prefill``, in chunks
  (``models.prefill_chunk``);
- ``paged``: paged KV pools on the device and the hand-written CUDA
  paged-attention kernels (``repro_torch.kernels``), the paper's Llama-2
  testbed path, for single-stage full-attention stacks (dense or MoE, as
  the reference's paged step reads ``stage_0`` only).  With chunked
  prefill every iteration's prefill-chunk rows and decode rows go down in
  one ragged ``_paged_decode_step`` call; with whole-prompt prefill the
  prompt's cache is scattered into pages.

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

A vision-language stack (``vision_stub``: InternVL2) runs on slots with
whole-prompt prefill: each request carries one image's worth of stubbed
patch embeddings, drawn with numpy from the request id exactly as the
reference draws them, ahead of its prompt; its cache positions, and its
decode, start at ``prompt_len`` plus the patches.

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
from repro_torch.models.layers import (apply_rope, dtype_of, embed, rmsnorm,
                                       unembed)
from repro_torch.models.model import (check_ported, decode_step,
                                      ffn_forward, init_cache, layer_params,
                                      model_stages, prefill, prefill_chunk,
                                      supports_chunked_prefill)
from repro_torch.serving.batch_core import BatchConfig, BatchCore
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.kv_cache import (PagePool, make_pools,
                                          scatter_prefill)
from repro_torch.serving.prefix_cache import PrefixCache
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
                 backend: str = "slots", page_size: int = 16,
                 seed: int = 0, sample_temp: float = 0.0,
                 chunked: Optional[bool] = None,
                 prefill_chunk_tokens: int = 512,
                 target_iter_time: float = 0.25,
                 slo_budget: str = "static",
                 prefix_cache: bool = False,
                 kv_quant: bool = False,
                 keep_first_logits: bool = False,
                 observer=None, admission=None, device=None):
        if backend not in ("slots", "paged"):
            raise ValueError(f"backend must be 'slots' or 'paged', got "
                             f"{backend!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sched = scheduler
        self.max_slots = max_slots
        self.max_len = max_len
        # debug/test probe: retain each request's first-token logits row
        self.keep_first_logits = keep_first_logits
        self.cm = cost_model or CostModel(cfg)
        if chunked is None:
            chunked = supports_chunked_prefill(cfg)
        elif chunked:
            assert supports_chunked_prefill(cfg), \
                f"{cfg.name}: no incremental-prefill support (see " \
                "models.supports_chunked_prefill)"
        self.chunked = chunked
        if kv_quant:
            # int8 KV pages (DESIGN.md §16) live in the paged pools and
            # are dequantized inside the kernel; the slots backend keeps
            # its own fp caches
            assert backend == "paged" and self.chunked, \
                "kv_quant requires the paged backend + chunked prefill"
        if prefix_cache:
            # shared-prefix radix KV cache (DESIGN.md §9): only the paged
            # backend can point several block tables at one physical page,
            # and only chunked prefill can resume from a cached offset
            assert backend == "paged" and self.chunked, \
                "prefix_cache requires the paged backend + chunked prefill"
        check_ported(cfg)
        if cfg.is_encoder_decoder:
            # the reference fails such a stack later: its prefill passes
            # no frames, and its paged step asserts
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only stacks: its "
                "requests carry no audio frames for an encoder-decoder's "
                "encoder; run Whisper through models.prefill (with "
                "batch['frames']) and models.decode_step")
        if backend == "paged":
            if cfg.frontend == "vision_stub":
                # the reference takes such a stack and scatters only the
                # first prompt_len of its prompt_len + patches cache
                # positions into pages
                raise NotImplementedError(
                    f"{cfg.name}: the paged backend does not hold the "
                    "vision prefix (the JAX package's whole-prompt paged "
                    "install scatters prompt_len positions of a cache "
                    "that starts with the patches); serve it on "
                    "backend='slots'")
            if len(model_stages(cfg)) > 1:
                # the reference fails such a stack later, in its scan
                raise NotImplementedError(
                    f"{cfg.name}: the paged backend serves single-stage "
                    "stacks only: the JAX package's paged step reads "
                    "stage_0 only, so a stack with dense first layers "
                    "(DeepSeek-MoE-16B's first layer is dense) runs on "
                    "backend='slots'")
            kinds = {k for k, _, _ in model_stages(cfg)}
            assert kinds == {ATTN}, \
                "paged backend supports uniform dense-GQA stacks"
        self.kv_quant = kv_quant
        self.backend = backend
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
                        # stall-free chunked prefill + adaptive batching
                        # when the model layer supports cache continuation
                        adaptive_batching=chunked,
                        stall_free=chunked,
                        # page-rounded KV accounting on the paged backend
                        # (DESIGN.md §10): budget respected => pool never
                        # physically exhausts
                        kv_page_size=page_size if backend == "paged"
                        else 1),
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
        self.k_scales = self.v_scales = None
        if backend == "paged":
            n_pages = -(-self.kv_budget // page_size)
            self.pool = PagePool(n_pages, page_size)
            # the device pools carry one extra sacrificial page at index
            # n_pages, invisible to the allocator: the ragged launch pads
            # its row count to a power of two and every padding row writes
            # to (and attends over) this scratch page, never a live
            # request's
            self._scratch_page = n_pages
            if kv_quant:
                (self.k_pools, self.v_pools, self.k_scales,
                 self.v_scales) = make_pools(
                    cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                    cfg.resolved_head_dim(), quantized=True,
                    device=self.device)
            else:
                self.k_pools, self.v_pools = make_pools(
                    cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads,
                    cfg.resolved_head_dim(), dtype_of(cfg),
                    device=self.device)
        else:
            # inactive slots decode garbage into their own rows, which the
            # next admission to the slot overwrites
            self.cache = init_cache(cfg, max_slots, max_len,
                                    device=self.device)
        if prefix_cache:
            # a request admitted on a hit adopts the cached pages into its
            # block table and starts prefilling at the cached offset: its
            # chunk rows attend over the adopted pages in the same ragged
            # launch
            self.core.prefix_cache = PrefixCache(self.pool)
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.running = self.core.running    # alias: core owns the batch
        self.reserved = self.core.reserved  # alias: core owns KV accounting
        self.t_model = 0.0            # modeled target-hardware clock
        # wall clock of each iteration's model step (prefill and decode)
        # and its copy back, without the host's scheduling work:
        # (seconds, prefill rows, decode rows)
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
        req._vlm_prefix = 0
        req._pcache = None            # slots backend: partial prefill cache
        req._pos = 0
        self.slots[slot] = req
        self.running.append(req)

    def _drop_backend_state(self, req: Request):
        """Preemption (DESIGN.md §10): free the victim's physical KV (pool
        pages on the paged backend, the partial prefill cache on the slots
        backend) and vacate its slot.  The recompute path rebuilds
        everything at re-admission."""
        if self.backend == "paged":
            self.pool.release_request(req.rid)
        req._pcache = None
        slot = getattr(req, "_slot", None)
        if slot is not None and self.slots[slot] is req:
            self.slots[slot] = None
        req._slot = None

    # -- prefill ------------------------------------------------------------------
    def _tokens(self, req: Request, start: int, stop: int):
        return torch.from_numpy(np.asarray(
            req.prompt_tokens[None, start:stop], np.int64)).to(self.device)

    def _prefill_whole(self, req: Request):
        """One-shot prompt prefill (stacks without incremental prefill, or
        ``chunked=False``): one kernel launch per layer.  A vision stack's
        request gets its stubbed patches first: standard normals from
        ``default_rng(rid)``, drawn in f64 with numpy as the reference
        draws them, cast to the model dtype on the device."""
        batch = {"tokens": self._tokens(req, 0, req.prompt_len)}
        if self.cfg.frontend == "vision_stub":
            patches = np.random.default_rng(req.rid).standard_normal(
                (1, self.cfg.n_frontend_tokens, self.cfg.d_model))
            batch["patch_embeds"] = torch.from_numpy(patches).to(
                self.device, dtype_of(self.cfg))
            req._vlm_prefix = self.cfg.n_frontend_tokens
        logits, req._pcache = prefill(self.params, batch, self.cfg,
                                      self.max_len)
        return logits[0]

    def _prefill_chunk_slots(self, req: Request, start: int, chunk: int):
        if req._pcache is None:
            req._pcache = init_cache(self.cfg, 1, self.max_len,
                                     device=self.device)
        logits, req._pcache = prefill_chunk(
            self.params, self._tokens(req, start, start + chunk), self.cfg,
            req._pcache)
        return logits[0]

    def _run_prefill(self, req: Request, start: int, chunk: int):
        """Execute one planned chunk; returns the last-token logits row as
        f32 numpy (meaningful only when this chunk completes the prompt).
        Chunked paged prefill does not come through here: it rides the
        fused ragged launch (``_run_mixed_paged``)."""
        if not self.chunked:
            assert start == 0 and chunk == req.prompt_len
            row = self._prefill_whole(req)
        else:
            row = self._prefill_chunk_slots(req, start, chunk)
        return row.float().cpu().numpy()    # waits for the device

    def _run_mixed_paged(self, plan, decoding: List[Request], log=True):
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
        if log:
            self.iter_log.append((time.perf_counter() - t0, n_chunk_rows,
                                  len(decoding)))
        n_first = len(last_row)
        first_rows = {rid: logits[j] for j, rid in enumerate(last_row)}
        rows = {r.rid: logits[n_first + i] for i, r in enumerate(decoding)}
        return first_rows, rows

    def _install_prefill(self, req: Request, row):
        """Prompt fully prefilled: make the request decodable.  A
        whole-prompt cache is scattered into the request's pages (paged)
        or copied into its slot (slots), after this iteration's decode, so
        the full-width decode step never clobbers a partial prefill."""
        slot = req._slot
        if self.backend == "paged":
            if not self.chunked:
                self.pool.alloc(req.rid, req.prompt_len + 1)
                sc = req._pcache["stages"]["stage_0"]
                pages = self.pool.owned[req.rid]
                ps = self.pool.page_size
                scatter_prefill(self.k_pools, sc["k"][:, 0], pages, ps,
                                n_tokens=req.prompt_len)
                scatter_prefill(self.v_pools, sc["v"][:, 0], pages, ps,
                                n_tokens=req.prompt_len)
        else:
            for key, stage in self.cache["stages"].items():
                for name, dst in stage.items():
                    dst[:, slot] = req._pcache["stages"][key][name][:, 0]
            self.cache["pos"][slot] = req.prompt_len + req._vlm_prefix
        req._pcache = None
        req._next_token = int(np.argmax(row))
        if self.keep_first_logits:
            req._first_row = np.asarray(row, np.float32)
        req._pos = req.prompt_len + req._vlm_prefix

    # -- decode -------------------------------------------------------------------
    def _decode_slots(self, tokens_np):
        logits, self.cache = decode_step(
            self.params, torch.from_numpy(tokens_np).to(self.device),
            self.cache, self.cfg)
        return logits

    def _decode(self, decoding: List[Request]):
        """Batched one-token decode; returns {rid: logits row (np)}."""
        if not decoding:
            return {}
        if self.backend == "paged":
            return self._run_mixed_paged([], decoding, log=False)[1]
        tokens = np.zeros(self.max_slots, np.int64)
        for r in decoding:
            tokens[r._slot] = r._next_token
        logits = self._decode_slots(tokens).float().cpu().numpy()
        return {r.rid: logits[r._slot] for r in decoding}

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

        # 2+3. prefill + batched decode of every request that was DECODING
        #    at iteration start.  On the chunked paged backend both go
        #    down in ONE ragged launch (DESIGN.md §16).
        plan = self.core.plan_prefill(self.running)
        decoding = [r for r in self.running if r.state == DECODING]
        if self.backend == "paged" and self.chunked:
            first_rows, rows = self._run_mixed_paged(plan, decoding)
            done_prefill = [(req, first_rows[req.rid]) for req, _ in plan
                            if req.prefill_done >= req.prompt_len]
        else:
            t0 = time.perf_counter()
            done_prefill = []
            for req, chunk in plan:
                row = self._run_prefill(req, req.prefill_done - chunk,
                                        chunk)
                if req.prefill_done >= req.prompt_len:
                    done_prefill.append((req, row))
            rows = self._decode(decoding)
            if plan or decoding:
                self.iter_log.append((time.perf_counter() - t0,
                                      sum(c for _, c in plan),
                                      len(decoding)))

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
            if self.backend == "paged":
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
    with ``quantize_kv`` before the write.  MoE stacks run ``moe_ffn`` on
    every layer over all R rows, padding rows included, so they compete
    for dispatch capacity as in the reference.  Returns f32 logits of the
    rows ``out_rows`` only."""
    R = tokens.shape[0]
    quant = k_pools.dtype == torch.int8
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    x = embed(params["embed"], tokens).to(dtype_of(cfg))    # (R, d)
    pos = ctx_lens
    stage = params["stages"]["stage_0"]
    attn, ffn = stage["attn"], stage["ffn"]
    moe_flag = cfg.moe is not None
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
        x = x + ffn_forward(layer_params(ffn, i), h2, cfg, moe_flag)
    x = rmsnorm(params["final_norm"], x[out_rows.long()], cfg.norm_eps)
    return unembed(params["embed"], x).float()
