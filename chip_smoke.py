#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

The quickest proof that the port builds and serves on an NVIDIA H100:

1. device and build: the card's name and power limit (nvidia-smi), and
   the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc (one
   nvcc per source, all started together), with ptxas' registers and
   spill bytes (per kernel for the head-dim-256 instantiations), the
   dynamic shared memory of the tensor-core tiles at head dims 128 and
   256, and the SSD kernel's registers, shared memory and blocks per SM;
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes:
   - paged attention, serial and split-K, bf16 and int8 pools (Hq = Hkv
     = 32, D = 128, page 16): decode batches of 8 and 64 rows at table
     widths 32 and 256, and ragged mixed launches (a prefill chunk over
     one table row, 8 decode rows, padding rows with ctx 0); at
     StarCoder2-7B's shape (Hq 36 over Hkv 4: G = 9) a decode batch of 8
     rows and the 512-row mixed launch at width 32; at RecurrentGemma-
     2B's (Hq 10 over Hkv 1, D = 256: G = 10) run M's decode, 8 rows
     over 2048-slot rings (width 128), and the 512-row mixed launch; at
     Whisper large-v3's (Hq = Hkv = 20, D = 64) run N's decode, 8 rows
     over the 1500 encoder frames as 375 pages of 4 and over 448-slot
     caches as 28 pages of 16; each case once more with f32 queries and
     f32 pools at a tight tolerance;
   - flash attention (B = 1, Hq = 32, D = 128): S = 128, 1024 and 1000
     causal in bf16 and f32 (Hkv = 32), one windowed case (window 256),
     one GQA case (Hkv = 8), Mixtral-8x7B's prefill shape (S = 6144,
     Hkv = 8, window 4096) in bf16, Granite-3-2B's (S = 1024, Hkv =
     8, D = 64) in bf16 and f32, and MiniCPM3-4B's MLA prefill (Hq = Hkv
     = 40, D = 96 for q and k, Dv = 64 for v) at S = 1024 and 1000 in
     bf16 and f32, and RecurrentGemma-2B's local attention (Hq = 10 over
     Hkv = 1, D = 256, window 2048) at S = 1024 and 4500 in bf16 (f32 at
     D = 256 is refused by name: its tiles stop at 128), and Whisper
     large-v3's (B = 4, 20 heads of 64, not causal) encoder over 1500
     frames and cross-attention of 64 prompt rows over them (Sq != Skv)
     in bf16 and f32;
   - the flash backward (``csrc/flash_attention_bwd.cu``: delta, dK/dV,
     dQ; bf16 on the tensor cores, f32 on the FMA units) at run P's
     shape (Granite-3-2B: B 4, S 2048, 32 query heads over 8 kv heads of
     64, causal) and at Llama-2-7B's (B 1, S 4096, 32 heads of 128),
     bf16 and f32, and at RecurrentGemma-2B's (B 1, S 4096, 10 query
     heads over one kv head of 256, window 2048), MiniCPM3-4B's MLA (B
     4, S 2048, 40 heads, D 96 / Dv 64), Whisper large-v3's encoder (B
     8, S 1500, 20 heads of 64, not causal) and cross-attention (B 8, 448
     rows over 1500 frames) in bf16, fed the
     forward kernel's output and lse (the lse held to the plain
     forward's), against ``flash_attention_bwd_plain`` (f32: 1e-4 of the
     largest gradient; bf16: one bf16 step of it), timed beside the
     backward of ``scaled_dot_product_attention`` and the forward; f32
     above head dim 128 and bf16 above 256 refused by name;
   - the SSD scan at Mamba-2-2.7B's shape (H = 80, P = 64, G = 1, N =
     128, chunk 128): S = 128, 1024 and 1000 with bf16 and f32 x, S = 4096
     with bf16 x (2560 blocks, 32 chunks chained per head), and S = 1000
     bf16 from an initial state;
   - the SSD scan's backward (``csrc/ssd_scan_bwd.cu``: inject, chain,
     chunk, group sum; bf16 inject and chunk kernels on the tensor cores,
     f32 on the FMA units) at run U's shape
     (Mamba-2-2.7B training: B 4, S 2048, H 80, P 64, G 1, N 128, chunk
     128) in bf16, at S 1000 from an initial state with a nonzero dstate
     in bf16 and f32, and with 8 groups of 10 heads in bf16, fed the
     forward kernel's chunk states (held to the plain forward's), against
     ``ssd_scan_bwd_plain`` (f32: 1e-4 of each gradient's largest
     element; bf16: 2**-7 of it), timed beside the forward that writes
     the chunk states;
   - the public entry point ``kernels.ops.paged_attention_splitk`` at
     run C's narrow mixed launch (4 pages a table row, below the
     split-K threshold): one split-K launch a call, against its plain
     version.
   Each case prints one JSON line with errors and times (kernel, plain
   version, a library yardstick where one exists, the bound); and the
   slots backend's decode attention at run D's shape through the paged
   kernels over the slot caches, against its f32 plain version, its
   extra device memory asserted below one f32 copy of the caches; the
   same over int8 caches with their scales (run L's), within one bf16
   step of the kernels' plain version and within 2**-7 |ref| + 2 x 2**-9
   max|v| of the reference's route (and outside it with a planted fault),
   its extra memory below one bf16 copy of the caches; and MLA's absorbed latent decode at run K's shape (``torch.bmm``
   with f32 outputs over the latent cache), against its plain version,
   its extra memory below one f32 copy of the latent cache;
3. the engine at full width, a dozen requests from three clients under
   the Equinox scheduler with a MoPE predictor trained by the port:
     A  Llama-2-7B as registered (32 layers, d_model 4096, bf16; random
        weights from a seed), paged, fp pools, max_len 512 (table width
        >= 32: the split-K kernel),
     B  A with int8 KV pages,
     C  A with max_len 64, prompt + output < 64 (the serial kernel),
     D  A's weights and requests on the slots backend with whole-prompt
        prefill, max_len 1280 (the flash kernel, one launch per layer and
        prompt); its first-token logits against run A's,
     E  Mamba-2-2.7B as registered (64 layers, d_model 2560, bf16; random
        weights from a seed) on the slots backend, whose default for it
        is whole-prompt prefill (the SSD-scan kernel, one launch per layer
        and prompt), max_len 1280; plus prefill + one decode step against
        prefill of the longer prompt;
     F  DeepSeek-MoE-16B as registered (28 layers, d_model 2048, the first
        layer dense, then 64 routed experts top-6 and 2 shared, bf16;
        random weights from a seed) on the slots backend with
        whole-prompt prefill (the flash kernel), max_len 1280, capacity
        dispatch; its first-token logits against a plain forward of the
        port, prefill + one decode step against the longer prefill (on
        the dense MoE path: dispatch capacity follows the row count);
     G  Mixtral-8x7B at full width, depth cut 32 -> 16 layers (the whole
        model, 93.4 GB in bf16, exceeds the card), 8 experts top-2,
        window 4096, slots with whole-prompt prefill, max_len 6400; two
        of the 12 prompts are 4500-6000 tokens long, so flash masks by
        the window and their ring slot caches wrap; the same two checks
        at prompts past the window;
     H  StarCoder2-7B as registered (32 layers, d_model 4608, 36 query
        heads over 4 kv heads of 128, d_ff 18 432, GELU, vocab 49 152,
        bf16; random weights from a seed), paged like run A: G = 9 takes
        the split-K tensor-core walk for decode rows, never the one-row
        walk (asserted on its decode window); its first tokens against
        a plain forward,
     I  H's weights on multi-turn conversations that share system
        prompts, served cold and with the prefix cache: hits asserted,
        warm first-token logits against cold ones,
     J  a two-replica ``Cluster`` of paged Llama-2-7B engines over one
        weight set, Equinox schedulers sharing their fairness state,
        ``least_kv`` routing, a flight recorder per replica: the counter
        replay of the replicas' events equals the live counters, and the
        windowed Jain of the merged trace is printed;
     K  MiniCPM3-4B as registered (62 layers, d_model 2560, 40 heads,
        multi-head latent attention: q_lora 768, kv_lora 256, 64 + 32 QK,
        v 64; d_ff 6400, vocab 73 448, untied, bf16; random weights from
        a seed) on the slots backend, whole-prompt prefill through the
        flash kernel at D = 96 / Dv = 64 (once per layer and prompt, 744
        launches), the absorbed latent decode through ``torch.bmm`` (no
        paged launch); its first tokens against a plain forward, prefill
        + one decode step against the longer prefill;
     L  run D with int8 slot caches (``cfg.kv_quant``): the same weights
        and requests, decode through split-K over int8 pools with their
        scales (once per layer and decode step, counted per pool dtype);
        its first-token logits against run D's (prefill reads no cache),
        the greedy-token agreement with D reported;
     M  RecurrentGemma-2B as registered (26 layers, d_model 2560: 9 stages
        of two RG-LRU layers, d_rnn 2560, conv width 4, between 8 local-
        attention layers of 10 query heads over one kv head of 256,
        window 2048; d_ff 7680, vocab 256 000, untied, bf16; random
        weights from a seed) on the slots backend with whole-prompt
        prefill, max_len 6400; two of the 12 prompts are 4500-6000 tokens
        long, so flash masks by the window, the 2048-slot rings wrap and
        the RG-LRU scan runs many 256-step tiles with a ragged tail;
        flash at D = 256 once per attention layer and prompt (8 x 12),
        split-K at D = 256 once per attention layer and decode step, no
        SSD launch; first tokens of a long and a short prompt against a
        plain forward, prefill + one decode step past the window against
        the longer prefill;
     N  Whisper large-v3 as registered (32 encoder and 32 decoder layers,
        d_model 1280, 20 heads of 64, GELU MLP of 5120, vocab 51 866,
        untied, bf16; 1.60 B parameters; random weights from a seed)
        through the model API (``prefill``, ``decode_step``: the engine
        serves decoder-only stacks), max_len 448: two prefill calls of 4
        requests over (4, 1500, 1280) standard-normal frames, with the
        4-token start-of-transcript prompt and with a 64-token prompt
        (flash once per encoder layer, decoder self- and
        cross-attention: 96 a call, the cross-attention at Sq != Skv),
        then the 8 requests decode together greedily to 128 new tokens
        each (split-K once per decoder self- and cross-attention: 64 a
        step, the 1500 frames as pages of 4); first tokens of a short and
        a long prompt against a plain forward, prefill + one decode step
        at 444 tokens against the longer prefill;
     O  InternVL2-76B at full width (d_model 8192, 64 query heads over 8
        kv heads of 128, d_ff 28 672, vocab 128 256, untied, bf16; random
        weights from a seed), depth cut 80 -> 32 layers (the whole model,
        141 GB in bf16, exceeds the card), slots with whole-prompt
        prefill, max_len 1536: the 12 requests each carry the engine's
        256 stubbed patches ahead of the prompt (numpy normals from the
        request id, as the reference draws them), so flash runs once per
        layer and prompt at Sq = 256 + prompt (asserted per launch) and
        decode starts at prompt + 256 (split-K once per layer and step);
        first tokens against a plain forward over the same patches and
        tokens, prefill + one decode step after the prefix against the
        longer prefill, the decode profile window;
     P  Granite-3-2B as registered (40 layers, d_model 2048, 32 query
        heads over 8 kv heads of 64, d_ff 8192, vocab 49 155, tied, bf16,
        remat per layer; random weights from a seed) trained by
        ``training.train``: 8 AdamW steps (peak lr 3e-4, warmup 2, clip
        1.0, weight decay 0.01) on batches of 4 x 2048 tokens of the
        synthetic Markov stream; step 0's loss against ``loss_fn`` with
        the plain attention on the same weights and batch (within 1e-2),
        the loss falling, flash forward launched 2 x 40 x 8 times (the
        forward and its recompute under remat) and the backward's
        tensor-core variant 40 x 8; step times, tokens/s, peak memory and
        one profiled step (with the device time of the optimizer's
        ``adamw_update`` label and of the backward kernels, and the
        update profiled alone);
     Q  DeepSeek-MoE-16B at full width, depth cut 28 -> 7 layers (1
        dense + 6 MoE, 4.03 B parameters: a step holds ~12 bytes a
        parameter plus the optimizer's f32 temporaries, so all 28 layers,
        ~196 GB, exceed the card, and 8 layers run out of its memory),
        the capacity dispatch at capacity factor 1.0 (assignments past an
        expert's capacity drop), trained by ``training.train``: 4 AdamW
        steps of 4 x 2048 tokens, the MoE load-balance loss in the loss;
        step 0's aux reported, and whether two gradients of one batch
        are equal bit for bit;
     R  MiniCPM3-4B as registered (62 layers, MLA), trained as Q: 4 x
        2048 tokens, flash and its backward at D = 96 / Dv = 64;
     S  Whisper large-v3 as registered (32 + 32 layers), trained as Q on
        8 x 448 tokens over 1500 stubbed frames a row (``train`` draws
        them from the step's seed): the encoder without remat, the
        cross-attention's flash and backward at Sq 448, Skv 1500;
     T  RecurrentGemma-2B as registered (26 layers), trained as Q on 2 x
        4096 tokens, past the 2048 window: 8 local-attention layers at
        head dim 256 through flash and its backward, 18 RG-LRU layers in
        PyTorch;
     U  Mamba-2-2.7B as registered (64 layers, d_model 2560, 80 heads of
        64, state 128, chunk 128, vocab 50 280, bf16; 2.83 B parameters)
        trained as Q on 4 x 2048 tokens: the SSD scan forward twice a
        layer and step (remat), each time writing its chunk states, the
        SSD backward kernel once, no flash; two gradients of one batch
        compared bit for bit, their launches checked; then one profiled
        step (device ms by kernel and by class of kernel, busy share);
     each of Q-U with P's checks (step 0's loss within 1e-2 of the plain
     attention's and the plain SSD scan's, the loss falling, the flash
     and SSD-scan forward and backward launched as derived from the
     stack and nothing else of the port), step times, tokens/s and peak
     memory;
     V  run P through ``training.train(cfg, tc, mesh=make_host_mesh())``:
        a (1, 1) ("data", "model") DeviceMesh over NCCL at world size 1,
        the parameters cut by ``param_specs`` (``ShardPlan``: nothing to
        cut at world size 1), the batch rows by ``batch_specs``; its
        losses equal P's bit for bit, its launches P's, its step time,
        tokens/s and peak beside P's;
     W  run P over a (1, 2) ("data", "model") mesh: two rank processes
        on the one card (this script with ``--rank``, a group over a
        ``FileStore`` in a temporary directory; gloo carries the
        collectives, since NCCL refuses two ranks on one card), each
        keeping half of every split weight and gathering a layer's
        weights whole where it runs them (``models.sharding.
        GatherAtUse``: once in the forward, once more under remat, the
        gradient reduce-scattered back), each taking 2 of every batch's
        4 rows; the vocab of 49 155 does not split over 2, so the table
        stays whole.  P's first 2 steps: step 0's loss within 1e-3
        relative of P's, every step within 1e-2, flash 2 x 40 x 2 and its
        backward 40 x 2 on each rank, all ``mma``; each rank's peak and
        step time beside P's; the collectives the ranks counted, equal to
        the schedule's (``launch.dryrun.step_collectives``) at every step,
        and each kind's gloo rate alone on 64 MiB;
     X  DeepSeek-MoE-16B at full width, 4 of 28 layers (``reduced``),
        the capacity dispatch at 1.0 with ``fsdp=True`` over a (2, 1)
        mesh of two rank processes on the card (as W): every weight split
        over "data" and gathered at use, the MoE capacity, queue places
        and load-balance loss over the whole batch (one all-gather of
        routed-token counts per MoE layer and forward); the first 2 of
        TRAIN_QT's 4 steps against ``training.train`` of the same cut
        config and weights in one process on the card: step 0 within 1e-3
        relative, every step within 1e-2; each rank's peak beside the
        single process's;
     Y  RecurrentGemma-2B, 6 of 26 layers (``reduced``), over a (1, 2)
        mesh of two rank processes (as W), its RG-LRU branch
        channel-parallel over "model", against one process;
     Z  serving over a (1, 2) mesh of two rank processes on the card (as
        W; ``models.sharding.ServePlan``: query and kv heads, experts,
        the FFN hidden dim, MLA heads and latent rank, Mamba-2 heads and
        channels, RG-LRU channels and the vocab over "model", only
        activations moved): ``models.prefill`` of 4 prompts of 512
        tokens, then 16 ``decode_step`` calls teacher-forced with one
        process's greedy tokens over caches of 1024 slots, for Z1
        Llama-2-7B as registered, Z2 Mixtral-8x7B at 4 of 32 layers (4 of
        its 8 experts a rank), Z3 Llama-2-7B at 8 layers with int8 slot
        caches, Z4 MiniCPM3-4B (31 of 62 layers, MLA: flash at D 96 / Dv
        64 on 20 of 40 heads, the latent cache over its rank, the absorbed
        decode's partial scores all-reduced), Z5 Mamba-2-2.7B (32 of 64
        layers: the SSD scan on 40 of 80 heads; cuts in ``reduced``) and
        Z6 RecurrentGemma-2B (26 layers: the RG-LRU branch
        on 1280 of 2560 channels, local attention "mixed", flash on 5 of
        10 query heads at D 256), Z7 Whisper large-v3 (32 + 32 layers,
        10 of 20 heads a rank in the encoder, the decoder and the
        cross-attention: 4 prompts of 64 tokens over (4, 1500, 1280)
        frames into caches of 448) and Z8 InternVL2-76B (8 of 80 layers,
        ``reduced``: 256 patches ahead of 256 tokens); each rank launches
        flash once per attention layer on its heads (Z7: per encoder
        layer and per decoder layer's self- and cross-attention),
        split-K once per GQA layer (Z7: and cross-attention) and step on
        its heads' cache shards where they split, and the SSD scan once
        per Mamba-2 layer (asserted, with the heads each launch saw),
        counts its collectives (equal to ``serve_schedule``, asserted),
        and every call's logits stay within 5e-2 of the largest of one
        process's on the same weights and inputs, run first, its greedy
        tokens agreeing at 0.9 of the calls' rows or more (bf16 ties
        counted as agreement; asserted); each rank's prefill and decode
        ms, the gloo transport's share of each, its shard, cache and peak
        bytes;
   then ring attention (``models.ring_attention``) in bf16 at
   Llama-2-7B's attention (S 32 768, 32 heads of 128, causal) and
   Granite-3-2B's GQA (S 16 384, 32 query heads over 8 kv heads of 64,
   causal and full): through the host mesh (n = 1) bit for bit one flash
   call, and the ring's steps and merge over 8 shards in one process
   (one flash call with lse a step: 36 causal, 64 full, counted) within
   3 x 2**-8 max|v| of one flash call and of the f32 plain ring, their ms
   beside the single call's;
   runs D, F, G, L, M and O decode over their slot caches through the
   split-K paged kernels (once per attention layer and decode step,
   asserted), and their decode steps, and K's, take less extra memory
   than an f32 copy of one layer's caches (K: of its latent cache);
   plus a check of run A's first-token logits against a dense forward,
   and ``torch.profiler`` windows (device busy share, kernel launches and
   device time by kernel per iteration): decode-heavy windows of the
   configurations of runs A, D-H and K-O (after at most 14 iterations
   that run the prompts in), prefill-heavy windows of E, G and M (the
   first iteration: the whole prompts of the requests it admits) and N
   (one prefill call), and one training step of runs P and U;
   runs A, B and D-X must go through the tensor-core (``mma``) variants
   of their forward kernels and launch no ``fma`` variant, and no kernel
   a run does not expect (the backward kernels only in runs P-X);
4. the port's engine examples through their ``main()`` on the card:
   ``examples/quickstart_torch.py`` (MoPE, a reduced Llama-2 under
   Equinox) and ``examples/serve_multiarch_torch.py`` (every registered
   architecture's smoke config, the encoder-decoder refused by the
   engine), each one's seconds on the ``examples`` line;
5. the dry-run (``python -m repro_torch.launch.dryrun --arch llama2-7b
   --shape train_4k,decode_32k --mesh single``) in a subprocess that sees
   no card (a fake process group of 256 ranks): one device's
   argument and output bytes, FLOPs and collective bytes (training's
   schedule and, for decode_32k, serving's); and ``launch.train
   --production`` on this one card, which must refuse with the
   world-size message;
6. a ``seconds`` line (wall time of each phase), the nvidia-smi line, a
   ``kernels`` JSON line (the four ports of the Pallas kernels and the
   flash and SSD-scan backward kernels; launches per variant beside the
   totals), and last the result line ``{"ok": true, "device":
   {...}}``.

Any failed check exits non-zero; no phase catches an error and goes on.
Without a CUDA device it exits 2 before printing any result.  TF32 is
switched off for matmuls and cuDNN, so f32 products are full f32.

    python3 chip_smoke.py

``python3 chip_smoke.py --rank RUN RANK WORLD STORE OUT`` is one rank
process of run W, X or Y (``mesh_rank_main``), ``--rank Z[:RUNS] RANK WORLD
STORE OUT`` one of run Z (``serve_rank_main``), which the script starts
itself.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict
from typing import Dict

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain version on the same inputs, elementwise
# |kernel - plain| <= atol + rtol * |plain|.  Both compute in f32 and
# round once to the output type, so bf16 outputs may differ by one bf16
# step (at most 2**-7 of the value); f32 outputs by summation order only.
BF16_TOL = (2 ** -7, 1e-5)         # (rtol, atol): bf16 q, bf16 or int8 pools
F32_TOL = (1e-5, 1e-5)             # f32 q, f32 pools
# the SSD scan: the gate of tests/test_kernels.py::test_ssd_kernel
SSD_BF16_TOL = (2 ** -7, 1e-4)
SSD_F32_TOL = (0.0, 5e-4)
# the SSD backward kernel vs its plain version, each gradient's max |d|
# within a share of its largest |plain|: f32 sums in other orders (and
# the kernel's compensated la_cum) at 1e-4; bf16 dx, dB and dC rounded
# once each, at SSD_BF16_TOL's 2**-7 (one bf16 step at the top)
SSD_BWD_REL = {"float32": 1e-4, "bfloat16": SSD_BF16_TOL[0]}
# int8 pools vs the bf16 pools they were quantized from: the noise bound
# of tests/test_paged_kernels.py (0.15 x std of the fp output), held by
# the RMS of the difference; its max is reported (it grows with the
# number of elements, while the std does not)
INT8_NOISE_REL_STD = 0.15
DENSE_REL_TOL = 5e-2               # served vs dense-forward first-token logits
MAX_LEN_SLOTS = 1280               # runs D-F: prompts <= 1024, outputs <= 128
# run G: Mixtral-8x7B's depth cut to 16 of its 32 layers (23.5 B of 46.7 B
# parameters, 47 of 93.4 GB in bf16: the whole model exceeds the card's
# 80 GB); fewer layers make the host's share of an iteration larger
MIXTRAL_LAYERS = 16
MAX_LEN_LONG = 6400                # runs G, M: prompts <= 6000, outputs <= 128
# runs G and M: two prompts past the window (Mixtral's 4096,
# RecurrentGemma's 2048)
LONG_PROMPTS = (4500, 6001)
# RecurrentGemma-2B's decode shape in the kernel phase (run M: 8 slots,
# 10 query heads over one kv head of 256, rings of 2048 slots = 128
# pages of 16)
D256_DECODE = "gqa10_d256_decode8_w128"
# Whisper large-v3's decode shapes in the kernel phase (run N: 8 rows, 20
# heads of 64): the cross-attention over 1500 frames (pages of gcd(1500,
# 16) = 4 slots) and the self-attention over max_len 448 (pages of 16)
WHISPER_CROSS_DECODE = "whisper_cross_decode8_p4_w375"
WHISPER_SELF_DECODE = "whisper_self_decode8_w28"
# run N: Whisper's published decoder context (n_text_ctx), the new tokens
# each request decodes, and its start-of-transcript prompt (large-v3's
# <|startoftranscript|><|en|><|transcribe|><|notimestamps|>)
MAX_LEN_WHISPER = 448
WHISPER_NEW_TOKENS = 128
WHISPER_SOT = (50258, 50259, 50360, 50364)
# run O: InternVL2-76B's depth cut to 32 of its 80 layers (29.5 B of 70.6 B
# parameters, 59.0 of 141.1 GB in bf16: the whole model exceeds the card's
# 80 GB); 256 patches + a prompt of up to 1024 + up to 128 outputs
INTERNVL_LAYERS = 32
MAX_LEN_VLM = 1536
# run P: Granite-3-2B training at full width and depth, the JAX
# package's TrainConfig fields
TRAIN = dict(batch=4, seq_len=2048, steps=8, peak_lr=3e-4, warmup=2,
             weight_decay=0.01, grad_clip=1.0, log_every=1, seed=SEED)
TRAIN_LOSS_TOL = 1e-2              # step 0's loss vs the plain attention's
# runs Q-T: 4 AdamW steps of each stack family's registered config
# (run -> arch, depth or None for all layers, batch, sequence length);
# Q's 7 of 28 layers are the deepest that fit: 7 peaked at 65.8 GiB on an
# H100 80GB HBM3 (79.2 GiB), 8 ran out of memory in the optimizer update
TRAIN_QT = dict(TRAIN, steps=4)
TRAIN_RUNS = {
    "Q": ("deepseek-moe-16b", 7, 4, 2048),
    "R": ("minicpm3-4b", None, 4, 2048),
    "S": ("whisper-large-v3", None, 8, 448),
    "T": ("recurrentgemma-2b", None, 2, 4096),
    "U": ("mamba2-2.7b", None, 4, 2048),
}
# runs W, X and Y: training over a mesh of two rank processes on the one
# card (run -> arch, depth or None, (data, model) mesh, TrainConfig fields,
# config fields replaced, steps run: the first of TrainConfig's steps,
# under its learning-rate schedule); each within TRAIN_LOSS_TOL of its
# baseline at every step and MESH_STEP0_REL relative at step 0.  Each
# runs its first 2 steps (the smoke's time): W the first 2 of run P's 8
# (held to P's first 2 losses), X and Y the first 2 of TRAIN_QT's 4; Y is RecurrentGemma-2B with its RG-LRU branch
# channel-parallel over the model axis (the config's
# train_batch_over_model=False), 6 of 26 layers (two (rec, rec, attn)
# units) at run T's shape
MESH_RUNS = {
    "W": ("granite-3-2b", None, (1, 2), TRAIN, {}, 2),
    "X": ("deepseek-moe-16b", 4, (2, 1), TRAIN_QT, {"fsdp": True}, 2),
    "Y": ("recurrentgemma-2b", 6, (1, 2),
          dict(TRAIN_QT, batch=2, seq_len=4096), {}, 2),
}
MESH_STEP0_REL = 1e-3
MESH_RANK_TIMEOUT_S = 420
# run Z: serving over a (1, 2) mesh of two rank processes on the card
# (``models.sharding.ServePlan``: heads, experts, FFN hidden, MLA heads
# and latent rank, Mamba-2 heads and channels, RG-LRU channels and vocab
# over "model"), held to one process's prefill / decode_step on the same
# weights and tokens: name -> (arch, n_layers or None: as registered,
# config fields replaced, why the depth is cut or None); SERVE_PROMPTS
# prompts of SERVE_PROMPT_LEN tokens, then SERVE_STEPS decode steps
# teacher-forced with the one process's greedy tokens, caches of
# SERVE_MAX_LEN (64 pages of 16: the split-K kernel) where
# ``serve_mesh_inputs`` gives no other; Z3 runs first: its calls warm each rank
# process (the CUDA context, cuBLAS, the kernel libraries), so the
# others' times are a warm process's
SERVE_MESH_RUNS = {
    "Z3": ("llama2-7b", 8, {"kv_quant": True},
           "the smoke's time: Z1 serves the full depth; Z3 adds the int8 "
           "caches' route"),
    "Z1": ("llama2-7b", None, {}, None),
    "Z2": ("mixtral-8x7b", 4, {},
           "two rank processes, each drawing the whole tree before it "
           "keeps its shards, and the one-process baseline share one card"),
    "Z4": ("minicpm3-4b", 31, {},
           "the smoke's time: the 62-layer sub-run took 25-37 s (a decode "
           "step makes 311 gloo calls: 5 a layer)"),
    "Z5": ("mamba2-2.7b", 32, {},
           "the smoke's time (the 64-layer sub-run took 25-30 s: 16 decode "
           "steps of 257 gloo calls); and at 64 layers rounding order alone "
           "moves one process's logits by 3.7e-2 (the gated norm's sum in "
           "two halves) to 5.0e-2 (out_proj in two f32 halves) of the "
           "largest, bf16 against f32 6.8e-2 (scripts/"
           "rounding_sensitivity.py), the floor under DENSE_REL_TOL"),
    "Z6": ("recurrentgemma-2b", None, {}, None),
    # Whisper's encoder-decoder: prompts of WHISPER_SOT and drawn tokens,
    # SERVE_WHISPER_PROMPT_LEN in all, over (4, 1500, 1280) frames, caches
    # of MAX_LEN_WHISPER (its own decoder context)
    "Z7": ("whisper-large-v3", None, {}, None),
    # InternVL2's vision prefix: 256 patches ahead of 256 tokens, the
    # SERVE_PROMPT_LEN positions
    "Z8": ("internvl2-76b", 8, {},
           "two rank processes, each drawing the whole tree (about 18 GB "
           "at 8 layers; the whole model about 152 GB) before it keeps its "
           "shards, share one 80 GB card"),
}
SERVE_MESH = (1, 2)
SERVE_PROMPTS, SERVE_PROMPT_LEN = 4, 512
SERVE_STEPS, SERVE_MAX_LEN = 16, 1024
SERVE_WHISPER_PROMPT_LEN = 64
# the least greedy agreement of a Z run's ranks with one process, over
# every call's argmax of the teacher-forced steps, a bf16 tie counted as
# agreement (``greedy_flips``: with a vocab of 128 256 InternVL2's bf16
# logits tie at the top, and each of Z8's flips sat at a margin of 0 or
# one bf16 step)
SERVE_GREEDY_MIN = 0.9
# run W's ranks also time each collective kind alone on bf16 CUDA tensors
# of this many MiB of input, TRANSPORT_REPS calls after one warm-up
TRANSPORT_MIB = 64
TRANSPORT_REPS = 2
# the flash backward kernel vs its plain version: f32 sums in other orders
# (max |d| within 1e-4 of the largest |plain|); bf16: both widen the same
# inputs to f32 and round once (max |d| within one bf16 step of the
# largest |plain|)
BWD_F32_REL = 1e-4
BWD_BF16_STEPS = 1
LSE_TOL = 2e-5                     # f32 lse: |d| <= tol (1 + max |lse|)
# the ring phase: bf16 at two full-width attention shapes (name, S, Hq,
# Hkv, D, causal): Llama-2-7B's and Granite-3-2B's GQA, causal and full;
# the ring over RING_SHARDS sequence shards in one process
RING_SHARDS = 8
RING_CASES = [("llama2_S32768_h32_d128", 32768, 32, 32, 128, True),
              ("granite_S16384_gqa4_d64", 16384, 32, 8, 64, True),
              ("granite_S16384_gqa4_d64_full", 16384, 32, 8, 64, False)]
# the dry-run line: the CLI in a subprocess on the CPU (a fake process
# group of 256 ranks: the single-pod mesh; the CPU tests cover the
# multi-pod one), a training and a serving shape, held to this many
# seconds
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_MESHES = ("single",)
DRYRUN_ARGS = ("--arch", "llama2-7b", "--shape", ",".join(DRYRUN_SHAPES),
               "--mesh", *DRYRUN_MESHES)
DRYRUN_TIMEOUT_S = 300


# wall seconds: each phase of main, each run group of the engine phase
# (``engine/<runs>``), and the profile windows and reference checks summed
# over all runs; printed as the ``seconds`` line
SECONDS: Dict[str, float] = defaultdict(float)
# each training run's ``train`` line (run V is held to run P's)
TRAIN_LINES: Dict[str, dict] = {}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        if sys.argv[2].split(":")[0] == "Z":
            return serve_rank_main(sys.argv[2].split(":")[1:] + sys.argv[3:])
        return mesh_rank_main(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    # per kernel: registers and spill bytes; those of each library, and
    # the head-dim-256 instantiations in full
    ptxas = {name: _build.ptxas_report(_build.build_log(name))
             for name in built}
    regs = {name: sorted({f"{k['registers']} registers"
                          for k in kernels.values()})
            for name, kernels in ptxas.items()}
    spills = {name: sorted({f"{k['spill_stores']} B stores, "
                            f"{k['spill_loads']} B loads"
                            for k in kernels.values()})
              for name, kernels in ptxas.items()}
    d256 = {k: v for kernels in ptxas.values() for k, v in kernels.items()
            if "<256" in k or "<(int)256" in k}
    check(d256, "build: no head-dim-256 instantiation in the ptxas report")
    # the backward's instantiations in full; its tensor-core kernels below
    # head dim 256 spill nothing
    bwd = ptxas["flash_attention_bwd"]
    spilled = [k for k, v in bwd.items() if "mma" in k and "256" not in k
               and v["spill_stores"] + v["spill_loads"]]
    check(not spilled, f"build: backward kernels spill: {spilled}")
    # the SSD backward's tensor-core kernels: no spills, two blocks an SM
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    spilled = [k for k, v in ptxas["ssd_scan_bwd"].items() if "mma" in k
               and v["spill_stores"] + v["spill_loads"]]
    check(not spilled, f"build: SSD backward kernels spill: {spilled}")
    check(ss.bwd_mma_attrs()["blocks_per_sm"] == 2,
          f"build: SSD backward chunk kernel: {ss.bwd_mma_attrs()}")
    SECONDS["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": SECONDS["build"],
          "libraries": built, "ptxas_registers": regs,
          "ptxas_spill_bytes": spills, "ptxas_d256": d256,
          "ptxas_flash_attention_bwd": bwd,
          "ptxas_ssd_scan_bwd": ptxas["ssd_scan_bwd"],
          "tile_smem_bytes": tile_smem_bytes(),
          "ssd_scan:mma": ss.mma_attrs(),
          "ssd_scan_bwd:mma": ss.bwd_mma_attrs()})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(torch, *args)
        SECONDS[phase] = time.perf_counter() - t
        return out

    kernel_rows = timed("paged_kernels", kernel_phase, flush)
    kernel_rows.update(timed("flash", flash_phase, flush))
    kernel_rows.update(timed("flash_bwd", flash_bwd_phase, flush))
    kernel_rows.update(timed("ssd", ssd_phase, flush))
    kernel_rows.update(timed("ssd_bwd", ssd_bwd_phase, flush))
    kernel_rows["paged_attention_splitk"]["slot_int8_decode"] = \
        timed("slot_attention", slot_attention_phase, flush)
    kernel_rows["paged_attention_splitk"]["ops_entry"] = \
        timed("ops_splitk", ops_splitk_phase, flush)
    timed("engine_runs", engine_phase, kernel_rows)
    timed("examples", examples_phase)
    timed("dryrun", dryrun_phase)
    SECONDS["total"] = time.perf_counter() - t0

    emit({"phase": "seconds", **SECONDS})
    print(smi, flush=True)
    emit({"kernels": list(kernel_rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def tile_smem_bytes():
    """Dynamic shared memory of one block of each tensor-core kernel at
    head dims 128 and 256 (the backward's dK/dV and dQ kernels too), from
    the libraries' own size functions; each under the 227 KB (232 448 B)
    a block may take."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    out = {}
    for d in (128, 256):
        out[f"flash_attention:mma/d{d}"] = \
            fa._lib().flash_attention_mma_smem_bytes(d, d)
        for kernel, what in ((0, "dkdv"), (1, "dq")):
            out[f"flash_attention_bwd:mma/{what}/d{d}"] = \
                fa._bwd_lib().flash_attention_bwd_smem_bytes(d, d, 1, kernel)
        for quant, pools in ((0, "bf16"), (1, "int8")):
            for thin, walk in ((0, "tensor-core walk"), (1, "one-row walk")):
                out[f"paged_attention:mma/{pools}/{walk}/d{d}"] = \
                    pa._lib().paged_attention_mma_smem_bytes(d, d, quant, thin)
    check(all(0 < b <= 232448 for b in out.values()),
          f"build: a tile's shared memory is outside (0, 232448] B: {out}")
    return out


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps, flush):
    """Median of CUDA-event times of ``reps`` calls, each after the L2
    cache (50 MB) was overwritten, as a layer's pools are cold."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_attention(torch, q, k_pool, v_pool, tables, ctx, row_map,
                      k_scale, v_scale):
    """Yardstick only: gather each row's pages, dequantize int8 pages,
    then one ``scaled_dot_product_attention`` with the ctx mask."""
    F = torch.nn.functional
    B, Hq, D = q.shape
    pages = tables[row_map.long()].long()                 # (B, W)
    T = pages.shape[1] * k_pool.shape[1]

    def gather(pool, scale):
        x = pool[pages]
        if scale is not None:
            x = x.to(q.dtype) * scale[pages].to(q.dtype)[..., None]
        return x.reshape(B, T, pool.shape[2], -1).transpose(1, 2)

    k, v = gather(k_pool, k_scale), gather(v_pool, v_scale)
    mask = (torch.arange(T, device=q.device)[None] < ctx[:, None])
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None],
        enable_gqa=k.shape[1] != Hq)[:, :, 0]


def bound(torch, q, k_pool, v_pool, tables, ctx, row_map, k_scale):
    """(ms, bound_by): the larger of the bytes this call must move (each
    needed K/V slot once: rows sharing a table row share its prefix; q,
    out, tables, ctx, row_map) over HBM bandwidth and its multiply-adds
    over the peak rate for q's type."""
    need = torch.zeros(tables.shape[0], dtype=torch.long, device=q.device)
    need.scatter_reduce_(0, row_map.long(), ctx.long(), "amax")
    n_tok = int(need.sum())
    Hkv, D, Dv = k_pool.shape[2], k_pool.shape[3], v_pool.shape[3]
    per_tok = Hkv * (D + Dv) * k_pool.element_size()
    if k_scale is not None:
        per_tok += 2 * Hkv * k_scale.element_size()
    io = (q.numel() * q.element_size() * (1 + Dv / D) + tables.numel() * 4
          + ctx.numel() * 4 + row_map.numel() * 4)
    t_bytes = (n_tok * per_tok + io) / HBM_BYTES_PER_S * 1e3
    flops = int(ctx.long().sum()) * q.shape[1] * 2 * (D + Dv)
    peak = {torch.bfloat16: 989e12, torch.float32: 67e12}[q.dtype]
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tol_ratio(out, plain, tol):
    """(max abs error, max of |out - plain| / (atol + rtol |plain|)):
    the second is at most 1 when every element is within tolerance."""
    rtol, atol = tol
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    return d.max().item(), (d / (atol + rtol * p.abs())).max().item()


def kernel_cases():
    """(name, ctx list, row_map list, table rows, width, Hq, Hkv, D, page)
    at the serving path's shapes: Llama-2-7B's (MHA, 32 heads of 128),
    StarCoder2-7B's (36 query heads over 4 kv heads: G = 9, so a decode
    row is one tile of 9 (row, head) pairs and a chunk's tiles hold 7
    rows, 63 pairs), RecurrentGemma-2B's (10 query heads over one kv
    head of 256: G = 10; run M's decode over its 2048-slot rings, 128
    pages of 16, and a mixed launch whose tiles hold 6 rows, 60 pairs)
    and Whisper large-v3's (run N's decode of 8 rows, 20 heads of 64: the
    cross-attention over 1500 frames, 375 pages of 4, and the
    self-attention over 448 slots, 28 pages of 16)."""
    rng = np.random.default_rng(SEED)
    cases = []
    for w in (32, 256):
        for b in (8, 64):
            ctx = rng.integers(1, 16 * w + 1, b)
            ctx[0] = 16 * w                           # one full table
            cases.append((f"decode{b}_w{w}", ctx.tolist(), list(range(b)),
                          b, w, 32, 32, 128, 16))
    for w, chunk, n_pad in ((32, 512, 1024), (4, 48, 64)):
        cases.append(mixed_case(rng, w, chunk, n_pad, 32, 32))
    rng = np.random.default_rng(SEED + 16)
    ctx = rng.integers(1, 16 * 32 + 1, 8)
    ctx[0] = 16 * 32
    cases.append(("gqa9_decode8_w32", ctx.tolist(), list(range(8)), 8, 32,
                  36, 4, 128, 16))
    cases.append(mixed_case(rng, 32, 512, 1024, 36, 4, prefix="gqa9_"))
    rng = np.random.default_rng(SEED + 18)
    ctx = rng.integers(1, 16 * 128 + 1, 8)
    ctx[0] = 16 * 128
    cases.append((D256_DECODE, ctx.tolist(), list(range(8)), 8, 128, 10, 1,
                  256, 16))
    cases.append(mixed_case(rng, 32, 512, 1024, 10, 1, D=256,
                            prefix="gqa10_d256_"))
    rng = np.random.default_rng(SEED + 19)
    cases.append((WHISPER_CROSS_DECODE, [1500] * 8, list(range(8)), 8, 375,
                  20, 20, 64, 4))
    ctx = rng.integers(1, 449, 8)
    ctx[0] = 448
    cases.append((WHISPER_SELF_DECODE, ctx.tolist(), list(range(8)), 8, 28,
                  20, 20, 64, 16))
    return cases


def mixed_case(rng, w, chunk, n_pad, Hq, Hkv, D=128, prefix=""):
    """One prefill chunk from position 0 over table row 0, 8 decode rows
    on rows 1..8, padding rows with ctx 0 on the spare row 9."""
    dec = rng.integers(1, 16 * w + 1, 8).tolist()
    ctx = list(range(1, chunk + 1)) + dec + [0] * (n_pad - chunk - 8)
    rmap = [0] * chunk + list(range(1, 9)) + [9] * (n_pad - chunk - 8)
    return (f"{prefix}mixed{chunk}+8_w{w}", ctx, rmap, 16, w, Hq, Hkv, D, 16)


def case_inputs(torch, ci, case):
    """Case ``ci`` of ``kernel_cases()``'s inputs on the card, in f32,
    drawn from SEED + ci: q, the two pools, the page tables (the first
    pages of a permutation of the pool) and the ctx and row_map tensors."""
    _, ctx_l, rmap_l, n_tab, W, Hq, Hkv, D, page = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + ci)
    n_pool = n_tab * W + 1
    q32 = torch.randn(len(ctx_l), Hq, D, generator=g, device=dev)
    kp32 = torch.randn(n_pool, page, Hkv, D, generator=g, device=dev)
    vp32 = torch.randn(n_pool, page, Hkv, D, generator=g, device=dev)
    perm = torch.randperm(n_pool, generator=torch.Generator().manual_seed(ci))
    tables = perm[:n_tab * W].reshape(n_tab, W).to(torch.int32).to(dev)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    rmap = torch.tensor(rmap_l, dtype=torch.int32, device=dev)
    return q32, kp32, vp32, tables, ctx, rmap


def kernel_phase(torch, flush):
    from repro_torch.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain,
        paged_attention_splitk_kernel, paged_attention_splitk_plain)
    from repro_torch.models.attention import quantize_kv

    pps = 4
    rows = {"paged_attention": {"name": "paged_attention", "route": "cuda",
                                "source": "src/repro_torch/csrc/paged_attention.cu",
                                "replaces": "src/repro/kernels/paged_attention.py:242",
                                "max_abs_err": 0.0},
            "paged_attention_splitk": {
                "name": "paged_attention_splitk", "route": "cuda",
                "source": "src/repro_torch/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:312",
                "max_abs_err": 0.0}}
    # the cases that carry each kernel's times into the kernels line: the
    # shapes runs A (split-K, width 32) and C (serial, width 4) launch
    main_case = {"paged_attention": ("mixed48+8_w4", "bf16"),
                 "paged_attention_splitk": ("mixed512+8_w32", "bf16")}
    for ci, case in enumerate(kernel_cases()):
        name, ctx_l, _, _, W, Hq, Hkv, D, _ = case
        B = len(ctx_l)
        q32, kp32, vp32, tables, ctx, rmap = case_inputs(torch, ci, case)
        q, kp, vp = (t.to(torch.bfloat16) for t in (q32, kp32, vp32))
        zero = ctx == 0
        valid = ~zero
        for pools in ("bf16", "int8", "f32"):
            tol = F32_TOL if pools == "f32" else BF16_TOL
            if pools == "int8":
                kq, ks = quantize_kv(kp)
                vq, vs = quantize_kv(vp)
                args, scales = (q, kq, vq, tables, ctx), (ks, vs)
            elif pools == "f32":
                args, scales = (q32, kp32, vp32, tables, ctx), (None, None)
            else:
                args, scales = (q, kp, vp, tables, ctx), (None, None)
            kw = dict(row_map=rmap, k_scale=scales[0], v_scale=scales[1])
            o_s, m_s, l_s = paged_attention_kernel(*args, return_stats=True,
                                                   **kw)
            o_k, m_k, l_k = paged_attention_splitk_kernel(
                *args, pages_per_split=pps, return_stats=True, **kw)
            torch.cuda.synchronize()
            p_s = paged_attention_plain(*args, **kw)
            p_k = paged_attention_splitk_plain(*args, pages_per_split=pps,
                                               **kw)
            err_s, ratio_s = tol_ratio(o_s, p_s, tol)
            err_k, ratio_k = tol_ratio(o_k, p_k, tol)
            line = {"phase": "kernels", "case": name, "pools": pools,
                    "rows": B, "width": W, "Hq": Hq, "Hkv": Hkv, "D": D,
                    "rtol": tol[0], "atol": tol[1],
                    "serial_err": err_s, "splitk_err": err_k,
                    "serial_tol_ratio": ratio_s, "splitk_tol_ratio": ratio_k,
                    "ctx0_rows": int(zero.sum()),
                    "ctx0_exact_zero": bool((o_s[zero] == 0).all()
                                            and (o_k[zero] == 0).all()),
                    "m_bitwise": bool(torch.equal(m_s, m_k)),
                    "finite": bool(torch.isfinite(o_s.float()).all()
                                   and torch.isfinite(o_k.float()).all())}
            check(ratio_s <= 1 and ratio_k <= 1,
                  f"{name}/{pools}: kernel vs plain outside tolerance "
                  f"{tol}: max abs error {err_s}, {err_k}; ratio to the "
                  f"tolerance {ratio_s}, {ratio_k}")
            check(line["ctx0_exact_zero"], f"{name}/{pools}: ctx=0 rows "
                  "are not exact zeros")
            check(line["m_bitwise"], f"{name}/{pools}: split-K m differs "
                  "from serial m")
            check(line["finite"], f"{name}/{pools}: non-finite output")
            if pools == "f32":           # checked, not timed
                emit(line)
                for kname, err in (("paged_attention", err_s),
                                   ("paged_attention_splitk", err_k)):
                    rows[kname]["max_abs_err_f32"] = max(
                        rows[kname].get("max_abs_err_f32", 0.0), err)
                continue
            if pools == "int8":
                ref_fp = paged_attention_plain(q, kp, vp, tables, ctx,
                                               row_map=rmap).float()[valid]
                std = ref_fp.std().item()
                for kname, o in (("serial", o_s), ("splitk", o_k)):
                    d = o.float()[valid] - ref_fp
                    rms = d.square().mean().sqrt().item() / std
                    line[f"{kname}_int8_noise_rms_rel_std"] = rms
                    line[f"{kname}_int8_noise_max_rel_std"] = \
                        d.abs().max().item() / std
                    check(rms < INT8_NOISE_REL_STD,
                          f"{name}/int8: {kname} quantization noise {rms} "
                          f"(RMS over the fp output's std) above "
                          f"{INT8_NOISE_REL_STD}")
            line["serial_ms"] = time_ms(
                torch, lambda: paged_attention_kernel(*args, **kw), 20, flush)
            line["splitk_ms"] = time_ms(
                torch, lambda: paged_attention_splitk_kernel(
                    *args, pages_per_split=pps, **kw), 20, flush)
            line["plain_ms"] = time_ms(
                torch, lambda: paged_attention_plain(*args, **kw), 3, flush)
            line["splitk_plain_ms"] = time_ms(
                torch, lambda: paged_attention_splitk_plain(
                    *args, pages_per_split=pps, **kw), 3, flush)
            line["library_ms"] = time_ms(
                torch, lambda: library_attention(torch, *args, rmap, *scales),
                5, flush)
            line["bound_ms"], line["bound_by"] = bound(
                torch, q, args[1], args[2], tables, ctx, rmap, scales[0])
            emit(line)
            for kname, err, ms, plain in (
                    ("paged_attention", err_s, "serial_ms", "plain_ms"),
                    ("paged_attention_splitk", err_k, "splitk_ms",
                     "splitk_plain_ms")):
                row = rows[kname]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                fn = paged_attention_kernel if kname == "paged_attention" \
                    else paged_attention_splitk_kernel
                if main_case[kname] == (name, pools):
                    row["ms_by_kernel"] = device_ms_by_kernel(
                        torch, lambda: fn(*args, **kw), flush)
                    row.update(ms=line[ms], plain_ms=line[plain],
                               bound_ms=line["bound_ms"],
                               bound_by=line["bound_by"],
                               library_ms=line["library_ms"],
                               shape=f"{name}/{pools}")
                shapes = "d256_shapes" if D == 256 else \
                    "whisper_shapes" if name.startswith("whisper_") else None
                if shapes and pools == "bf16":
                    # RecurrentGemma-2B's head dim (run M's decode shape
                    # and the mixed launch) and Whisper large-v3's decode
                    # shapes (run N), each with its device time by kernel
                    # (the plan, the walk, the combine)
                    row.setdefault(shapes, {})[name] = dict(
                        ms=line[ms], plain_ms=line[plain],
                        bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                        library_ms=line["library_ms"],
                        tol_ratio=line[f"{ms[:-3]}_tol_ratio"],
                        ms_by_kernel=device_ms_by_kernel(
                            torch, lambda: fn(*args, **kw), flush))
    return rows


def ops_splitk_phase(torch, flush):
    """The public entry point ``kernels.ops.paged_attention_splitk`` (split-K
    whatever the table width) at run C's narrow launch, mixed48+8_w4 in
    bf16 (4 pages a table row, below ``SPLIT_K_THRESHOLD_PAGES``, where
    ``ops.paged_attention`` takes the serial kernel): the inputs
    ``kernel_phase`` draws for that case, held to
    ``paged_attention_splitk_plain`` at BF16_TOL, one split-K launch a
    call, timed beside the plain version and the serial kernel.  Returns
    the line for the split-K row of the kernels line."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_splitk_plain)

    name = "mixed48+8_w4"
    ci, case = next((i, c) for i, c in enumerate(kernel_cases())
                    if c[0] == name)
    W = case[4]
    check(W < ops.SPLIT_K_THRESHOLD_PAGES, f"ops split-K: {name} is "
          f"{W} pages wide, not below the threshold")
    q32, kp32, vp32, tables, ctx, rmap = case_inputs(torch, ci, case)
    q, kp, vp = (t.to(torch.bfloat16) for t in (q32, kp32, vp32))
    args = (q, kp, vp, tables, ctx)
    reset_launch_counts()
    out = ops.paged_attention_splitk(*args, row_map=rmap)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    check(counts.get("paged_attention_splitk") == 1
          and not counts.get("paged_attention"), f"ops split-K: a call "
          f"launched {counts}")
    plain = paged_attention_splitk_plain(
        *args, pages_per_split=ops.DEFAULT_PAGES_PER_SPLIT, row_map=rmap)
    err, ratio = tol_ratio(out, plain, BF16_TOL)
    line = {"phase": "kernels", "kernel": "paged_attention_splitk",
            "entry": "kernels.ops.paged_attention_splitk", "case": name,
            "pools": "bf16", "width": W,
            "pages_per_split": ops.DEFAULT_PAGES_PER_SPLIT,
            "launches_per_call": counts, "rtol": BF16_TOL[0],
            "atol": BF16_TOL[1], "max_abs_err": err, "tol_ratio": ratio,
            "ms": time_ms(torch, lambda: ops.paged_attention_splitk(
                *args, row_map=rmap), 20, flush),
            "serial_ms": time_ms(torch, lambda: paged_attention_kernel(
                *args, row_map=rmap), 20, flush),
            "plain_ms": time_ms(torch, lambda: paged_attention_splitk_plain(
                *args, pages_per_split=ops.DEFAULT_PAGES_PER_SPLIT,
                row_map=rmap), 3, flush)}
    line["bound_ms"], line["bound_by"] = bound(torch, q, kp, vp, tables, ctx,
                                               rmap, None)
    emit(line)
    check(ratio <= 1, f"ops split-K {name}: off the plain version by {err} "
          f"(ratio {ratio} to {BF16_TOL})")
    reset_launch_counts()
    return {k: line[k] for k in ("case", "width", "max_abs_err", "tol_ratio",
                                 "ms", "serial_ms", "plain_ms", "bound_ms",
                                 "bound_by")}


def device_ms_by_kernel(torch, fn, flush, reps=5,
                        names=("paged_attention", "paged_plan")):
    """Device ms per call of each kernel that ``fn`` launches whose name
    holds one of ``names`` (the plan, the walks and the combine of a paged
    call), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us and any(n in e.key for n in names):
            out[e.key[:80]] += us / 1e3 / reps
    return dict(out)


def kernel_modules():
    """The three kernel modules (by module: the package exports functions
    of the same names)."""
    return [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("paged_attention", "flash_attention", "ssd_scan")]


def launch_counts():
    counts = {}
    for mod in kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


def reset_launch_counts():
    for mod in kernel_modules():
        mod.reset_launch_counts()


def flash_bound(Sq, Skv, Hq, Hkv, D, causal, window, dtype, Dv=None, B=1):
    """(ms, bound_by): q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D | Dv) read
    and out (B, Sq, Hq, Dv) written once over HBM bandwidth, against the
    multiply-adds of the (q, k) pairs the mask keeps (QK^T over D and PV
    over Dv, 2 operations each) over the peak for the type.  The mask is
    the kernel's, aligned top-left: all Sq x Skv pairs when neither causal
    nor windowed."""
    Dv = D if Dv is None else Dv
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = B * (Sq * Hq + Skv * Hkv) * (D + Dv) * elem
    pairs = 0
    for qpos in range(Sq):
        lo = max(0, qpos - window + 1) if window else 0
        hi = min(qpos + 1, Skv) if causal else Skv
        pairs += max(0, hi - lo)
    flops = 2 * B * pairs * (D + Dv) * Hq
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch, flush):
    """The flash-attention kernel against its plain version at the
    whole-prompt prefill shapes of Llama-2-7B (B = 1, 32 heads, D = 128),
    Mixtral-8x7B (8 kv heads, window 4096, a 6144-token prompt),
    Granite-3-2B (8 kv heads of 64), MiniCPM3-4B's MLA prefill (40
    heads, D = 96 for q and k, Dv = 64 for v: the tile is 128 wide, so
    96-127 of Q/K and 64-127 of V are zero-filled columns),
    RecurrentGemma-2B's local attention (10 query heads over one kv head
    of 256, window 2048, at S = 1024 and 4500: the 256-wide tile, Q in
    shared memory; bf16 only, f32 at 256 is refused by name) and Whisper
    large-v3's (run N: B = 4, 20 heads of 64, not causal): the encoder's
    self-attention over 1500 frames and the decoder's cross-attention of
    a 64-token prompt over them (Sq != Skv);
    library yardstick: ``scaled_dot_product_attention`` (a windowed case
    passes its mask as a boolean tensor; Sq != Skv it takes as is), timed
    here only.  The kernels line carries S1024 causal bf16, MiniCPM3's
    S1024 bf16 (``mla_shape``), RecurrentGemma's two (``d256_shapes``)
    and Whisper's four (``whisper_shapes``); S1024, the Mixtral case,
    RecurrentGemma's and Whisper's bf16 cases add the profiler's device
    time (``ms_by_kernel``)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    F = torch.nn.functional
    dev = torch.device("cuda")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:93",
           "max_abs_err": 0.0}
    # (name, S, Hq, Hkv, D, Dv, causal, window, dtype[, Skv, B]): Skv = S
    # and B = 1 unless given
    cases = [(f"S{S}_causal", S, 32, 32, 128, 128, True, 0, dt)
             for S in (128, 1024, 1000) for dt in ("bfloat16", "float32")]
    cases += [("S1024_window256", 1024, 32, 32, 128, 128, True, 256,
               "bfloat16"),
              ("S1024_gqa8", 1024, 32, 8, 128, 128, True, 0, "bfloat16"),
              ("S6144_window4096_gqa8", 6144, 32, 8, 128, 128, True, 4096,
               "bfloat16")]
    # Granite-3-2B's prefill shape: 32 query heads over 8 kv heads of 64
    cases += [("S1024_gqa8_d64", 1024, 32, 8, 64, 64, True, 0, dt)
              for dt in ("bfloat16", "float32")]
    # MiniCPM3-4B's MLA prefill: 40 heads, D = 96 (64 + 32), Dv = 64
    cases += [(f"S{S}_mla_d96_dv64", S, 40, 40, 96, 64, True, 0, dt)
              for S in (1024, 1000) for dt in ("bfloat16", "float32")]
    # RecurrentGemma-2B's local attention: 10 query heads over one kv head
    # of 256, window 2048, inside it and past it (bf16: the f32 kernel's
    # tiles stop at 128, and its refusal is checked below)
    cases += [(name, S, 10, 1, 256, 256, True, 2048, "bfloat16")
              for name, S in (("S1024_gqa10_d256", 1024),
                              ("S4500_gqa10_d256_window2048", 4500))]
    # Whisper large-v3 (run N's prefill call of 4 requests): the encoder
    # over 1500 frames, the cross-attention of 64 prompt rows over them
    cases += [(name, Sq, 20, 20, 64, 64, False, 0, dt, 1500, 4)
              for name, Sq in (("whisper_enc_S1500", 1500),
                               ("whisper_cross_Sq64_Skv1500", 64))
              for dt in ("bfloat16", "float32")]
    q32 = torch.zeros((1, 16, 1, 256), device=dev)
    try:
        fa.flash_attention_kernel(q32, q32, q32)
        fail("flash: f32 at head dim 256 was not refused")
    except ValueError as e:
        check("[4, 128]" in str(e), f"flash: f32 at head dim 256 refused "
              f"without naming the limit: {e}")
    for ci, case in enumerate(cases):
        name, S, Hq, Hkv, D, Dv, causal, window, dt = case[:9]
        Skv, B = case[9:] if len(case) > 9 else (S, 1)
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + ci)
        dtype = getattr(torch, dt)
        q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Skv, Hkv, Dv, generator=g, device=dev).to(dtype)
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        out = fa.flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        err, ratio = tol_ratio(out, plain, tol)
        check(out.shape == plain.shape == (B, S, Hq, Dv),
              f"flash {name}/{dt}: output shape {tuple(out.shape)}")
        check(ratio <= 1, f"flash {name}/{dt}: kernel vs plain outside "
              f"tolerance {tol}: max abs error {err}, ratio {ratio}")
        check(bool(torch.isfinite(out.float()).all()),
              f"flash {name}/{dt}: non-finite output")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window and window < S:       # a window past S masks nothing
            pos = torch.arange(S, device=dev)
            mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None]
                                                   - window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=Hkv != Hq)

        line = {"phase": "kernels", "kernel": "flash_attention",
                "case": name, "dtype": dt, "B": B, "S": S, "Skv": Skv,
                "Hq": Hq, "Hkv": Hkv, "D": D, "Dv": Dv, "causal": causal,
                "window": window, "rtol": tol[0],
                "atol": tol[1], "max_abs_err": err, "tol_ratio": ratio,
                "ms": time_ms(torch, lambda: fa.flash_attention_kernel(
                    q, k, v, causal=causal, window=window), 20, flush),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window), 3, flush),
                "library_ms": time_ms(torch, library, 10, flush)}
        line["bound_ms"], line["bound_by"] = flash_bound(
            S, Skv, Hq, Hkv, D, causal, window, dt, Dv, B)
        whisper = name.startswith("whisper_")
        if dt == "bfloat16" and (whisper or name in (
                "S1024_causal", "S6144_window4096_gqa8", "S1024_gqa10_d256",
                "S4500_gqa10_d256_window2048")):
            line["ms_by_kernel"] = device_ms_by_kernel(
                torch, lambda: fa.flash_attention_kernel(
                    q, k, v, causal=causal, window=window), flush,
                names=("flash_attention",))
        emit(line)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if (name, dt) == ("S1024_causal", "bfloat16"):
            row.update(ms=line["ms"], ms_by_kernel=line["ms_by_kernel"],
                       plain_ms=line["plain_ms"],
                       bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                       library_ms=line["library_ms"],
                       shape=f"{name}/{dt}")
        if (name, dt) == ("S1024_mla_d96_dv64", "bfloat16"):
            row["mla_shape"] = {k: line[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "tol_ratio")}
        if D == 256:
            row.setdefault("d256_shapes", {})[name] = {k: line[k] for k in (
                "ms", "ms_by_kernel", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "tol_ratio")}
        if whisper:
            row.setdefault("whisper_shapes", {})[f"{name}/{dt}"] = {
                k: line[k] for k in ("ms", "ms_by_kernel", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "tol_ratio") if k in line}
    return {"flash_attention": row}


def flash_bwd_bound(Sq, Skv, Hq, Hkv, D, Dv, causal, window, dtype, B=1):
    """(ms, bound_by) of the backward: q, k, v, out, dout and the f32 lse
    read and dq, dk, dv written once over HBM bandwidth, against the
    multiply-adds of the (q, k) pairs the mask keeps in its five products
    (S = QK^T and dQ = dS K over D and dK = dS^T Q over D; dP = dO V^T
    and dV = P^T dO over Dv; 2 operations each: 2.5x the forward's at D
    = Dv) over the peak for the inputs' type."""
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = B * (2 * Sq * Hq * (D + Dv) + 2 * Skv * Hkv * (D + Dv)) \
        * elem + B * Sq * Hq * 4
    pairs = 0
    for qpos in range(Sq):
        lo = max(0, qpos - window + 1) if window else 0
        hi = min(qpos + 1, Skv) if causal else Skv
        pairs += max(0, hi - lo)
    flops = 2 * B * pairs * Hq * (3 * D + 2 * Dv)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_ratio(torch, got, plain):
    """(max |got - plain|, that over the tolerance): f32 BWD_F32_REL of
    the largest |plain|, bf16 BWD_BF16_STEPS bf16 steps of it."""
    err = (got.float() - plain.float()).abs().max().item()
    top = plain.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        tol = BWD_BF16_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    else:
        tol = BWD_F32_REL * top
    return err, err / tol


def flash_bwd_phase(torch, flush):
    """The flash backward kernel (three launches: delta, dK/dV, dQ)
    against ``flash_attention_bwd_plain`` on the card, at run P's shape
    (Granite-3-2B: B 4, S 2048, 32 query heads over 8 kv heads of 64,
    causal) and at Llama-2-7B's (B 1, S 4096, 32 heads of 128), in bf16
    (the ``mma`` variant) and f32 (``fma``), and at RecurrentGemma-2B's
    local attention (B 1, S 4096, 10 query heads over one kv head of
    256, window 2048, causal) in bf16 (f32 stops at head dim 128), and in
    bf16 at the shapes of runs R and S: MiniCPM3-4B's MLA (B 4, S 2048,
    40 heads, D 96 for q and k, Dv 64 for v, causal), Whisper large-v3's
    encoder (B 8, S 1500, 20 heads of 64, not causal) and its
    cross-attention (B 8, 448 rows over 1500 frames, not causal); each
    fed the forward kernel's output and lse; the lse itself against the
    plain forward's.  Library yardstick: the backward of
    ``scaled_dot_product_attention`` through autograd (its forward run
    once, outside the timing; the window as a boolean mask; MLA's
    D != Dv as well).  The kernels line carries the Granite bf16
    case, run P's.  Head dims past a variant's tiles are refused by
    name."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    F = torch.nn.functional
    dev = torch.device("cuda")
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/attention.py:205",
           "max_abs_err": 0.0}
    # (name, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, dtypes): f32
    # stops at D = 128
    both, bf16 = ("bfloat16", "float32"), ("bfloat16",)
    cases = [("granite_B4_S2048_gqa4_d64", 4, 2048, 2048, 32, 8, 64, 64,
              True, 0, both),
             ("llama_B1_S4096_d128", 1, 4096, 4096, 32, 32, 128, 128, True,
              0, both),
             ("rgemma_B1_S4096_gqa10_d256_window2048", 1, 4096, 4096, 10, 1,
              256, 256, True, 2048, bf16),
             ("mla_B4_S2048_h40_d96_dv64", 4, 2048, 2048, 40, 40, 96, 64,
              True, 0, bf16),
             ("whisper_enc_B8_S1500_h20_d64", 8, 1500, 1500, 20, 20, 64, 64,
              False, 0, bf16),
             ("whisper_cross_B8_Sq448_Skv1500_h20_d64", 8, 448, 1500, 20, 20,
              64, 64, False, 0, bf16)]
    for ci, (name, B, S, Skv, Hq, Hkv, D, Dv, causal, window,
             dtypes) in enumerate(cases):
        for dt in dtypes:
            g = torch.Generator(device=dev).manual_seed(SEED + 300 + ci)
            dtype = getattr(torch, dt)
            q, k, v, do = (torch.randn(B, s_, h, d, generator=g,
                                       device=dev).to(dtype)
                           for s_, h, d in ((S, Hq, D), (Skv, Hkv, D),
                                            (Skv, Hkv, Dv), (S, Hq, Dv)))
            mask = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_kernel(q, k, v, return_lse=True,
                                                 **mask)
            _, p_lse = fa.flash_attention_plain(q, k, v, block_q=512,
                                                block_kv=512,
                                                return_lse=True, **mask)
            lse_err = (lse - p_lse).abs().max().item()
            check(lse_err <= LSE_TOL * (1 + p_lse.abs().max().item()),
                  f"flash {name}/{dt}: forward lse off the plain version's "
                  f"by {lse_err}")
            grads = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                                  **mask)
            torch.cuda.synchronize()
            plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                 block_q=512, block_kv=512,
                                                 **mask)
            errs = {}
            for gname, got, want in zip(("dq", "dk", "dv"), grads, plain):
                check(got.shape == want.shape and got.dtype == dtype,
                      f"flash backward {name}/{dt}: {gname} "
                      f"{tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got.float()).all()),
                      f"flash backward {name}/{dt}: non-finite {gname}")
                errs[gname] = bwd_ratio(torch, got, want)
                check(errs[gname][1] <= 1, f"flash backward {name}/{dt}: "
                      f"{gname} off the plain version by {errs[gname][0]} "
                      f"(ratio {errs[gname][1]})")
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            sdpa = dict(enable_gqa=Hkv != Hq)
            if window:                 # the band as a boolean mask
                pos = torch.arange(S, device=dev)
                sdpa["attn_mask"] = (pos[None] <= pos[:, None]) \
                    & (pos[None] > pos[:, None] - window)
            else:
                sdpa["is_causal"] = causal
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
            dot = do.transpose(1, 2)

            def library():
                torch.autograd.grad(o_lib, (qt, kt, vt), dot,
                                    retain_graph=True)

            line = {"phase": "kernels", "kernel": "flash_attention_bwd",
                    "case": name, "dtype": dt, "B": B, "S": S, "Skv": Skv,
                    "Hq": Hq, "Hkv": Hkv, "D": D, "Dv": Dv, "causal": causal,
                    "window": window,
                    "tolerance": (f"{BWD_BF16_STEPS} bf16 step of the "
                                  "largest |plain|" if dt == "bfloat16"
                                  else f"{BWD_F32_REL} x the largest "
                                  "|plain|"),
                    "max_abs_err": {k: e for k, (e, _) in errs.items()},
                    "tol_ratio": max(r for _, r in errs.values()),
                    "lse_max_abs_err": lse_err,
                    "ms": time_ms(torch, lambda: fa.flash_attention_bwd_kernel(
                        q, k, v, out, lse, do, **mask), 10, flush),
                    "plain_ms": time_ms(
                        torch, lambda: fa.flash_attention_bwd_plain(
                            q, k, v, out, lse, do, block_q=512,
                            block_kv=512, **mask), 3, flush),
                    "library_ms": time_ms(torch, library, 10, flush),
                    "forward_ms": time_ms(torch, lambda: fa.flash_attention_kernel(
                        q, k, v, return_lse=True, **mask), 10, flush)}
            line["bound_ms"], line["bound_by"] = flash_bwd_bound(
                S, Skv, Hq, Hkv, D, Dv, causal, window, dt, B)
            if dt == "bfloat16":
                line["ms_by_kernel"] = device_ms_by_kernel(
                    torch, lambda: fa.flash_attention_bwd_kernel(
                        q, k, v, out, lse, do, **mask), flush,
                    names=("flash_bwd",))
            emit(line)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     *line["max_abs_err"].values())
            row.setdefault("shapes", {})[f"{name}/{dt}"] = {
                k: line[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "tol_ratio",
                                     "forward_ms") + (
                    ("ms_by_kernel",) if "ms_by_kernel" in line else ())}
            if (ci, dt) == (0, "bfloat16"):
                row.update({k: line[k] for k in (
                    "ms", "ms_by_kernel", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}, shape=f"{name}/{dt}")
            del q, k, v, do, out, lse, p_lse, grads, plain, qt, kt, vt, o_lib
            torch.cuda.empty_cache()
    # head dims a variant's tiles do not take are refused by name: f32
    # above 128 (the FMA kernels), bf16 above 256 (the tensor-core tiles)
    for d, dt, limit in ((256, torch.float32, 128),
                         (264, torch.bfloat16, 256)):
        q = torch.zeros((1, 16, 1, d), device=dev, dtype=dt)
        try:
            fa.flash_attention_bwd_kernel(q, q, q, q, torch.zeros(
                (1, 16, 1), device=dev), q)
            fail(f"flash backward: {dt} at head dim {d} was not refused")
        except ValueError as e:
            check(f"above {limit}" in str(e), f"flash backward: {dt} at "
                  f"head dim {d} refused without naming the limit: {e}")
    return {"flash_attention_bwd": row}


def ssd_bound(S, H, P, N, chunk, dtype):
    """(ms, bound_by): x, la, B, C read and y and the f32 final state
    written once over HBM bandwidth, against the multiply-adds each
    chunk of this length needs (C B^T and its product with x over the
    causal pairs, C state^T and the state update), 2 operations each,
    over the peak for x's type."""
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = S * (2 * H * P + 2 * N) * elem + S * H * 4 + H * P * N * 4
    macs = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        pairs = q * (q + 1) // 2
        macs += H * (pairs * (N + P) + 2 * q * P * N)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_phase(torch, flush):
    """The SSD-scan kernel against its plain version at Mamba-2-2.7B's
    whole-prompt prefill shape; no single PyTorch call computes it."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    dev = torch.device("cuda")
    H, P, N, chunk = 80, 64, 128, 128
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:85",
           "max_abs_err": 0.0, "library_ms": None}
    # decays as the model makes them: la = -dt * A, dt log-uniform on
    # [1e-3, 1e-1] (softplus of the dt_bias draw), A = 1 .. H; x at unit
    # scale and B, C at 0.3 (the scores C.B then have unit scale at N =
    # 128, as in tests/test_torch_kernels_cuda.py: at unit-scale B and C
    # they reach 11, and f32 cancellation alone moves outputs near zero
    # past the 1e-4 absolute tolerance on either side)
    cases = [(f"S{S}", ci, S, dt, False) for ci, S in enumerate((128, 1024, 1000))
             for dt in ("bfloat16", "float32")]
    cases += [("S4096", 3, 4096, "bfloat16", False),
              ("S1000_init", 4, 1000, "bfloat16", True)]
    for name, ci, S, dt, with_init in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + 200 + ci)
        dtype = getattr(torch, dt)
        x = torch.randn(1, S, H, P, generator=g, device=dev).to(dtype)
        step = torch.exp(torch.rand(1, S, H, generator=g, device=dev)
                         * np.log(100.0) + np.log(1e-3))
        la = -step * torch.arange(1, H + 1, device=dev)
        Bm = (0.3 * torch.randn(1, S, 1, N, generator=g,
                                device=dev)).to(dtype)
        Cm = (0.3 * torch.randn(1, S, 1, N, generator=g,
                                device=dev)).to(dtype)
        init = torch.randn(1, H, P, N, generator=g, device=dev) \
            if with_init else None
        tol = SSD_BF16_TOL if dt == "bfloat16" else SSD_F32_TOL

        def kernel():
            return ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                                      initial_state=init)

        y, st = kernel()
        torch.cuda.synchronize()
        py, pst = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                    initial_state=init)
        err, ratio = tol_ratio(y, py, tol)
        st_err, st_ratio = tol_ratio(st, pst, SSD_F32_TOL)
        check(ratio <= 1 and st_ratio <= 1,
              f"ssd {name}/{dt}: kernel vs plain outside tolerance {tol}: "
              f"y error {err} (ratio {ratio}), state error {st_err} "
              f"(ratio {st_ratio})")
        check(bool(torch.isfinite(y.float()).all()
                   and torch.isfinite(st).all()),
              f"ssd {name}/{dt}: non-finite output")
        line = {"phase": "kernels", "kernel": "ssd_scan", "case": name,
                "dtype": dt, "variant": ss.VARIANTS[dtype], "S": S, "H": H,
                "P": P, "G": 1, "N": N, "chunk": chunk,
                "initial_state": with_init, "rtol": tol[0], "atol": tol[1],
                "max_abs_err": err, "tol_ratio": ratio,
                "state_max_abs_err": st_err, "state_tol_ratio": st_ratio,
                "ms": time_ms(torch, kernel, 20, flush),
                "ms_by_kernel": device_ms_by_kernel(
                    torch, kernel, flush, names=("ssd_scan",)),
                "plain_ms": time_ms(torch, lambda: ss.ssd_scan_plain(
                    x, la, Bm, Cm, chunk=chunk, initial_state=init), 3,
                    flush),
                "library_ms": None,
                "grid_blocks": ss.grid_blocks(x, chunk),
                "sms": torch.cuda.get_device_properties(
                    dev).multi_processor_count}
        line["bound_ms"], line["bound_by"] = ssd_bound(S, H, P, N, chunk, dt)
        emit(line)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if (name, dt) == ("S1024", "bfloat16"):
            row.update(ms=line["ms"], ms_by_kernel=line["ms_by_kernel"],
                       plain_ms=line["plain_ms"], bound_ms=line["bound_ms"],
                       bound_by=line["bound_by"], shape=f"{name}/{dt}")
    return {"ssd_scan": row}


def ssd_bwd_bound(B, S, H, P, G, N, chunk, dtype, init, dstate):
    """(ms, bound_by) of the SSD scan's backward: x, dy, B, C and the f32
    la (and initial state and dstate when given) read and dx, dB, dC, dla
    (and d(initial state)) written once over HBM bandwidth, against the
    multiply-adds of ``ssd_scan_bwd_plain``'s equations, 2 operations
    each, over the peak for x's type.  Per chunk of q positions and head,
    over its q (q + 1) / 2 causal pairs: C B^T and dM = dy x^T (N + P),
    sum_i M_ij dy_i (P), (dM o L) B and its transpose with C (2 N); and
    five (P, N) products a position: the chunk states recomputed (the
    function is given no states), dy (x) C into dS, dS B_j, dS^T x_j and
    S^T dy_i."""
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = B * S * (3 * H * P + 4 * G * N) * elem + 2 * B * S * H * 4 \
        + B * H * P * N * 4 * (int(init) * 2 + int(dstate))
    macs = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        macs += B * H * (q * (q + 1) // 2 * (3 * N + 2 * P) + 5 * q * P * N)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bwd_ratio(got, want, dt):
    """(max |got - want|, that over SSD_BWD_REL[dt] of the largest
    |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    top = max(want.float().abs().max().item(), 1e-30)
    return err, err / (SSD_BWD_REL[dt] * top)


# the SSD backward phase's cases: (name, B, S, G, dtype, initial state,
# dstate); the first is run U's shape
SSD_BWD_CASES = [("U_B4_S2048", 4, 2048, 1, "bfloat16", False, False),
                 ("S1000_init_dstate", 1, 1000, 1, "bfloat16", True, True),
                 ("S1000_init_dstate", 1, 1000, 1, "float32", True, True),
                 ("S1000_G8", 2, 1000, 8, "bfloat16", False, True)]


def ssd_bwd_inputs(torch, ci):
    """(x, la, Bm, Cm, dy, initial state, dstate) of SSD_BWD_CASES[ci] on
    the card (80 heads of 64, N 128), drawn as ``ssd_phase`` draws its
    inputs, dy unit normals."""
    _, B, S, G, dt, with_init, with_ds = SSD_BWD_CASES[ci]
    H, P, N = 80, 64, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 400 + ci)
    dtype = getattr(torch, dt)
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    step = torch.exp(torch.rand(B, S, H, generator=g, device=dev)
                     * np.log(100.0) + np.log(1e-3))
    la = -step * torch.arange(1, H + 1, device=dev)
    Bm, Cm = ((0.3 * torch.randn(B, S, G, N, generator=g,
                                 device=dev)).to(dtype) for _ in "BC")
    dy = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    init = torch.randn(B, H, P, N, generator=g, device=dev) \
        if with_init else None
    dstate = torch.randn(B, H, P, N, generator=g, device=dev) \
        if with_ds else None
    return x, la, Bm, Cm, dy, init, dstate


def ssd_bwd_phase(torch, flush):
    """The SSD scan's backward kernels (``csrc/ssd_scan_bwd.cu``: inject,
    chain, chunk, group sum) against ``ssd_scan_bwd_plain`` on the card,
    fed the forward kernel's chunk states (held to the plain forward's),
    inputs drawn as ``ssd_phase`` draws them and dy unit normals: at run
    U's shape (Mamba-2-2.7B training: B 4, S 2048, H 80, P 64, G 1, N
    128, chunk 128) in bf16, from no state and with no dstate as training
    runs it; at S 1000 with an initial state and a nonzero dstate in bf16
    and f32; and with 8 groups of 10 heads in bf16.  No PyTorch call
    computes it (``library_ms`` null).  The kernels line carries run U's
    case, with ``ms_by_kernel`` (inject, chain, chunk, group sum) and the
    bf16 chunk and inject kernels' registers, shared memory, blocks per
    SM and spill bytes (``mma_attrs``)."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    H, P, N, chunk = 80, 64, 128, 128
    row = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/models/ssm.py:88",
           "max_abs_err": 0.0, "library_ms": None,
           "mma_attrs": ss.bwd_mma_attrs()}
    for ci, (name, B, S, G, dt, with_init, with_ds) in enumerate(
            SSD_BWD_CASES):
        dtype = getattr(torch, dt)
        x, la, Bm, Cm, dy, init, dstate = ssd_bwd_inputs(torch, ci)
        _, _, cs = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                                      initial_state=init,
                                      return_chunk_states=True)
        _, _, p_cs = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                       initial_state=init,
                                       return_chunk_states=True)
        cs_err, cs_ratio = tol_ratio(cs, p_cs, SSD_F32_TOL)
        check(cs_ratio <= 1, f"ssd backward {name}/{dt}: the forward's "
              f"chunk states off the plain version's by {cs_err}")
        del p_cs

        def kernel():
            return ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, dstate,
                                          chunk=chunk, initial_state=init,
                                          chunk_states=cs)

        def plain():
            return ss.ssd_scan_bwd_plain(x, la, Bm, Cm, dy, dstate,
                                         chunk=chunk, initial_state=init)

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        errs = {}
        for gname, a, b in zip(("dx", "dla", "dB", "dC", "dinit"), got,
                               want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"ssd backward {name}/{dt}: {gname} {tuple(a.shape)} "
                  f"{a.dtype}, not {tuple(b.shape)} {b.dtype}")
            check(bool(torch.isfinite(a.float()).all()),
                  f"ssd backward {name}/{dt}: non-finite {gname}")
            errs[gname] = ssd_bwd_ratio(a, b, dt)
            check(errs[gname][1] <= 1, f"ssd backward {name}/{dt}: "
                  f"{gname} off the plain version by {errs[gname][0]} "
                  f"(ratio {errs[gname][1]})")
        del got, want
        line = {"phase": "kernels", "kernel": "ssd_scan_bwd", "case": name,
                "dtype": dt, "variant": ss.BWD_VARIANTS[dtype], "B": B,
                "S": S, "H": H, "P": P, "G": G, "N": N, "chunk": chunk,
                "initial_state": with_init, "dstate": with_ds,
                "tolerance": f"{SSD_BWD_REL[dt]} x each gradient's "
                             "largest |plain|",
                "max_abs_err": {k: e for k, (e, _) in errs.items()},
                "tol_ratio": {k: r for k, (_, r) in errs.items()},
                "chunk_states_max_abs_err": cs_err,
                "ms": time_ms(torch, kernel, 10, flush),
                "ms_by_kernel": device_ms_by_kernel(
                    torch, kernel, flush, names=("ssd_bwd",)),
                "plain_ms": time_ms(torch, plain, 3, flush),
                "library_ms": None,
                "forward_ms": time_ms(torch, lambda: ss.ssd_scan_kernel(
                    x, la, Bm, Cm, chunk=chunk, initial_state=init,
                    return_chunk_states=True), 10, flush),
                "forward_no_states_ms": time_ms(
                    torch, lambda: ss.ssd_scan_kernel(
                        x, la, Bm, Cm, chunk=chunk, initial_state=init), 10,
                    flush),
                "smem_bytes": ss.bwd_mma_attrs()["smem_bytes"]
                if dt == "bfloat16" else ss.bwd_smem_bytes()}
        line["bound_ms"], line["bound_by"] = ssd_bwd_bound(
            B, S, H, P, G, N, chunk, dt, with_init, with_ds)
        emit(line)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 *line["max_abs_err"].values())
        row.setdefault("shapes", {})[f"{name}/{dt}"] = {
            k: line[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "forward_ms", "forward_no_states_ms")}
        row["shapes"][f"{name}/{dt}"]["tol_ratio"] = max(
            line["tol_ratio"].values())
        if ci == 0:
            row.update({k: line[k] for k in (
                "ms", "ms_by_kernel", "plain_ms", "bound_ms", "bound_by")},
                shape=f"{name}/{dt}")
        del x, la, Bm, Cm, dy, init, dstate, cs
        torch.cuda.empty_cache()
    return {"ssd_scan_bwd": row}


def slot_attention_phase(torch, flush):
    """The slots backend's decode attention (``models.attention.
    decode_attention``), then run L's (``slot_int8_case``) and run K's
    (``mla_latent_case``); returns the int8 case's times for the split-K
    kernel's line.  At run D's decode shape (8 slots of 1280 tokens,
    32 heads of 128, bf16 caches): the paged kernels over a view of the
    caches as pages, held against its plain version (f32 products, the
    softmax weights rounded to bf16 as the reference rounds them) within
    that rounding's bound, 2**-7 relative + 2**-9 max|v| (the kernels keep
    the weights in f32; tests/test_torch_slot_attention.py); its extra
    peak memory must stay below one f32 copy of the two caches, which the
    plain version makes.  Library yardstick: ``scaled_dot_product_attention``
    with the validity mask."""
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_plain)

    dev = torch.device("cuda")
    B, S, H, D = 8, MAX_LEN_SLOTS, 32, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 300)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    pos = torch.randint(0, S, (B,), generator=g, device=dev)
    ctx = (pos + 1).clamp(max=S)
    valid = torch.arange(S, device=dev)[None] < ctx[:, None]
    f32_copy = 2 * k.numel() * 4
    got, extra = with_peak(torch, lambda: decode_attention(q, k, v, ctx))
    plain, plain_extra = with_peak(
        torch, lambda: decode_attention_plain(q, k, v, valid))
    tol = (2 ** -7, 2 ** -9 * v.float().abs().max().item())
    err, ratio = tol_ratio(got, plain, tol)
    check(ratio <= 1, f"slot decode attention vs plain outside the weight-"
          f"rounding bound {tol}: max abs error {err}, ratio {ratio}")
    check(bool(torch.isfinite(got.float()).all()),
          "slot decode attention: non-finite output")
    check(extra < f32_copy, f"slot decode attention took {extra} B of "
          f"extra device memory, not below one f32 copy of the caches "
          f"({f32_copy} B)")
    F = torch.nn.functional

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid[:, None, None])

    n_tok = int(ctx.sum())
    line = {"phase": "slot_attention", "case": "decode8_S1280_mha",
            "shape": [B, S, H, D], "dtype": "bfloat16",
            "rtol": tol[0], "atol": tol[1], "max_abs_err": err,
            "tol_ratio": ratio, "extra_peak_bytes": extra,
            "plain_extra_peak_bytes": plain_extra,
            "f32_copy_bytes": f32_copy,
            "ms": time_ms(torch, lambda: decode_attention(q, k, v, ctx), 20,
                          flush),
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                q, k, v, valid), 5, flush),
            "library_ms": time_ms(torch, library, 10, flush),
            "bound_ms": (n_tok * H * D * 2 * 2 + 2 * q.numel() * 2)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(line)
    int8 = slot_int8_case(torch, flush, q, k, v, ctx, valid)
    mla_latent_case(torch, flush)
    return int8


def with_peak(torch, fn):
    """fn's result and the device memory it took beyond the inputs."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def slot_int8_case(torch, flush, q, k_fp, v_fp, ctx, valid):
    """Run L's decode attention: the same shape over int8 slot caches
    with their bf16 per-(slot, head) scales (``cfg.kv_quant``), through
    the split-K kernel over int8 pools.  Held against the kernels' plain
    version on the same view (f32 dequantization: one bf16 step) and
    against the plain version of the slots route (the reference's:
    each dequantized value and weight rounded to bf16) within 2**-7 |ref|
    + 2 x 2**-9 max|v|.  Planted faults show the bound's reach: the last
    valid slot dropped and V's scales taken from the neighbouring head
    must fall outside it; a V code one too large is reported.  Its extra
    memory must stay below one bf16 copy of the caches (what dequantizing
    them whole would take).  Library yardstick: the caches dequantized to
    bf16, then masked SDPA."""
    from repro_torch.kernels.paged_attention import (
        LAUNCHES, paged_attention_splitk_plain)
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_plain,
                                              dequantize_kv, quantize_kv)

    B, S, H, D = k_fp.shape
    (k, ks), (v, vs) = quantize_kv(k_fp), quantize_kv(v_fp)
    bf16_copy = 2 * k.numel() * 2
    before = LAUNCHES["paged_attention_splitk/int8"]
    got, extra = with_peak(torch, lambda: decode_attention(
        q, k, v, ctx, k_scale=ks, v_scale=vs))
    check(LAUNCHES["paged_attention_splitk/int8"] == before + 1,
          "slot int8 decode attention: no split-K launch over int8 pools")
    page = 16
    tables = torch.arange(B * S // page, dtype=torch.int32,
                          device=q.device).view(B, -1)
    same = paged_attention_splitk_plain(
        q[:, 0], k.view(-1, page, H, D), v.view(-1, page, H, D), tables,
        ctx.to(torch.int32), k_scale=ks.view(-1, page, H),
        v_scale=vs.view(-1, page, H))
    err, ratio = tol_ratio(got[:, 0], same, BF16_TOL)
    ref, plain_extra = with_peak(torch, lambda: decode_attention_plain(
        q, k, v, valid, k_scale=ks, v_scale=vs))
    vmax = (v.float().abs().amax(-1) * vs.float())[valid].max().item()
    bound = (2 ** -7, 2 * 2 ** -9 * vmax)
    ref_err, ref_ratio = tol_ratio(got, ref, bound)
    v_plus_one = (v.to(torch.int16) + 1).clamp(max=127).to(torch.int8)
    faults = {"last_slot_dropped": (v, vs, (ctx - 1).clamp(min=1)),
              "v_scale_other_head": (v, vs.roll(1, -1), ctx),
              "v_code_plus_one": (v_plus_one, vs, ctx)}
    fault_ratios = {name: tol_ratio(decode_attention(
        q, k, fv, fctx, k_scale=ks, v_scale=fvs), ref, bound)[1]
        for name, (fv, fvs, fctx) in faults.items()}
    check(ratio <= 1, f"slot int8 decode attention vs the kernels' plain "
          f"version outside {BF16_TOL}: max abs error {err}, ratio {ratio}")
    check(ref_ratio <= 1, f"slot int8 decode attention vs the reference's "
          f"route outside {bound}: max abs error {ref_err}, ratio "
          f"{ref_ratio}")
    for name in ("last_slot_dropped", "v_scale_other_head"):
        check(fault_ratios[name] > 1, f"slot int8 decode attention: the "
              f"planted fault {name} stays within {bound} (ratio "
              f"{fault_ratios[name]})")
    check(bool(torch.isfinite(got.float()).all()),
          "slot int8 decode attention: non-finite output")
    check(extra < bf16_copy, f"slot int8 decode attention took {extra} B "
          f"of extra device memory, not below one bf16 copy of the caches "
          f"({bf16_copy} B)")
    F = torch.nn.functional

    def library():
        kd, vd = (dequantize_kv(c, sc, torch.bfloat16).transpose(1, 2)
                  for c, sc in ((k, ks), (v, vs)))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kd, vd, attn_mask=valid[:, None, None])

    n_tok = int(ctx.sum())
    line = {"phase": "slot_attention", "case": "decode8_S1280_mha_int8",
          "shape": [B, S, H, D], "dtype": "bfloat16/int8",
          "rtol": BF16_TOL[0], "atol": BF16_TOL[1], "max_abs_err": err,
          "tol_ratio": ratio, "ref_bound": list(bound),
          "ref_max_abs_err": ref_err, "ref_bound_ratio": ref_ratio,
          "planted_fault_ratios": fault_ratios,
          "extra_peak_bytes": extra, "plain_extra_peak_bytes": plain_extra,
          "bf16_copy_bytes": bf16_copy,
          "ms": time_ms(torch, lambda: decode_attention(
              q, k, v, ctx, k_scale=ks, v_scale=vs), 20, flush),
          "plain_ms": time_ms(torch, lambda: decode_attention_plain(
              q, k, v, valid, k_scale=ks, v_scale=vs), 5, flush),
          "library_ms": time_ms(torch, library, 10, flush),
          "bound_ms": (n_tok * H * (2 * D + 2 * 2) + 2 * q.numel() * 2)
          / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(line)
    return {k: line[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", "tol_ratio",
                                 "ref_bound_ratio")}


def mla_latent_case(torch, flush):
    """Run K's decode attention: MiniCPM3-4B's absorbed latent decode (8
    slots of 1280, 40 heads, latent 256, rotary 32, bf16), its products
    ``torch.bmm`` with f32 outputs over the caches in place
    (``mla_decode_attention_bmm``), against its plain version (f32
    products over f32 copies; both round the weights to bf16, so a
    weight may round the other way: 2**-8 max|c|).  Its extra memory
    must stay below one f32 copy of ``c``.  Library yardstick: masked
    SDPA over [c, k_rope] as one kv head (a copy of the caches)."""
    from repro_torch.models.attention import (mla_decode_attention,
                                              mla_decode_attention_plain)

    dev = torch.device("cuda")
    B, S, H, r, dr = 8, MAX_LEN_SLOTS, 40, 256, 32
    scale = 96 ** -0.5
    g = torch.Generator(device=dev).manual_seed(SEED + 301)
    q_lat = torch.randn(B, 1, H, r, generator=g, device=dev).bfloat16()
    q_rope = torch.randn(B, 1, H, dr, generator=g, device=dev).bfloat16()
    c = torch.randn(B, S, r, generator=g, device=dev).bfloat16()
    kr = torch.randn(B, S, dr, generator=g, device=dev).bfloat16()
    ctx = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    valid = torch.arange(S, device=dev)[None] < ctx[:, None]
    f32_copy = c.numel() * 4
    got, extra = with_peak(torch, lambda: mla_decode_attention(
        q_lat, q_rope, c, kr, ctx, scale))
    plain, plain_extra = with_peak(torch, lambda: mla_decode_attention_plain(
        q_lat, q_rope, c, kr, ctx, scale))
    tol = (1e-5, 2 ** -8 * c.float().abs().max().item())
    err, ratio = tol_ratio(got, plain, tol)
    check(ratio <= 1, f"MLA latent decode attention vs plain outside {tol}: "
          f"max abs error {err}, ratio {ratio}")
    check(bool(torch.isfinite(got).all()),
          "MLA latent decode attention: non-finite output")
    check(extra < f32_copy, f"MLA latent decode attention took {extra} B "
          f"of extra device memory, not below one f32 copy of c "
          f"({f32_copy} B)")
    F = torch.nn.functional

    def library():
        qq = torch.cat([q_lat, q_rope], -1).transpose(1, 2)   # (B, H, 1, .)
        kk = torch.cat([c, kr], -1)[:, None]                  # (B, 1, S, .)
        return F.scaled_dot_product_attention(
            qq, kk, c[:, None], attn_mask=valid[:, None, None], scale=scale,
            enable_gqa=True)

    n_tok = int(ctx.sum())
    t_bytes = n_tok * (r + dr) * 2 / HBM_BYTES_PER_S * 1e3
    t_ops = n_tok * H * 2 * (2 * r + dr) / PEAK_FLOPS["bfloat16"] * 1e3
    emit({"phase": "slot_attention", "case": "mla_latent_decode8_S1280_h40",
          "shape": [B, S, H, r, dr], "dtype": "bfloat16", "rtol": tol[0],
          "atol": tol[1], "max_abs_err": err, "tol_ratio": ratio,
          "extra_peak_bytes": extra, "plain_extra_peak_bytes": plain_extra,
          "f32_copy_bytes": f32_copy,
          "ms": time_ms(torch, lambda: mla_decode_attention(
              q_lat, q_rope, c, kr, ctx, scale), 20, flush),
          "plain_ms": time_ms(torch, lambda: mla_decode_attention_plain(
              q_lat, q_rope, c, kr, ctx, scale), 5, flush),
          "library_ms": time_ms(torch, library, 10, flush),
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations"})




# ---------------------------------------------------------------------------
# 3. the engine at full width
# ---------------------------------------------------------------------------
def token_spy():
    """An observer of every produced token, per request, in production
    order, and of the host clock at the end of every iteration."""
    from repro_torch.serving.telemetry import Observer

    class TokenSpy(Observer):
        def __init__(self):
            self.tokens = defaultdict(list)
            self.stamps = []

        def on_iteration(self, now, *, t_iter, util, fresh, running,
                         produced, first):
            self.stamps.append(time.perf_counter())
            for r in produced:
                self.tokens[r.rid].append(int(r._next_token))

    return TokenSpy()


def reduced_of(cfg):
    """The cut of a run's configuration from the registered one, or None."""
    from repro_torch.configs import get_config

    full = get_config(cfg.name)
    if full.n_layers == cfg.n_layers:
        return None
    return {"n_layers": [full.n_layers, cfg.n_layers],
            "n_params": [full.n_params(), cfg.n_params()],
            "why": "the whole model exceeds the card's memory; fewer layers "
                   "make the host's share of an iteration larger"}


def setup(torch, arch, n_layers=None):
    """(cfg, weights drawn on the card from SEED, cost model, MoPE);
    ``n_layers`` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.predictor import MoPE
    from repro_torch.serving.costmodel import H100_SXM, CostModel
    from repro_torch.weights import init_params
    from repro_torch.workloads import corpus

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cm = CostModel(cfg, H100_SXM)
    t0 = time.perf_counter()
    mope = MoPE(cm, corpus(4000, seed=SEED), epochs=20, seed=SEED)
    line = {"phase": "engine_setup", "model": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "n_params": cfg.n_params(),
            "weight_gib": n_bytes / 2 ** 30, "init_s": t_init,
            "mope_train_s": time.perf_counter() - t0}
    if reduced_of(cfg):
        line["reduced"] = reduced_of(cfg)
    emit(line)
    return cfg, params, cm, mope


def requests(short, long_prompts=0):
    """The 12 requests of every run (``short``: run C's, which fit
    max_len 64), from SEED; ``long_prompts``: that many of the first
    arrivals get prompts of LONG_PROMPTS tokens instead (runs G, M)."""
    from repro_torch.core import Request
    from repro_torch.workloads.traces import sample_prompt

    rng = np.random.default_rng(SEED + short)
    out = []
    for i in range(12):
        kw = sample_prompt(rng)[0]
        if short:
            plen = int(rng.integers(16, 40))
            olen = int(rng.integers(8, 64 - plen))
        else:
            plen = int(rng.integers(64, 1025))
            olen = int(rng.integers(16, 129))
        out.append(Request(rid=i, client=f"client{i % 3}",
                           arrival=0.02 * i, prompt_len=plen,
                           output_len=olen, keywords=kw))
    rng = np.random.default_rng(SEED + 2)
    for r in out[:long_prompts]:
        r.prompt_len = int(rng.integers(*LONG_PROMPTS))
    return out


def serve(torch, run, model, max_len, short, expect, long_prompts=0,
          reqs=None, **engine_kw):
    """One run on a fresh engine; ``expect`` maps each kernel to
    whether the run must launch it, or to an exact count: once per layer
    and whole-prompt prefill (``per_layer_prefill``) or per layer and
    slots decode step (``per_layer_decode``).  ``reqs``: the run's
    requests, else ``requests(short, long_prompts)``.  Returns the
    tokens, the first-token logits, the launch counts and the engine
    line."""
    from repro_torch.core import jain, make_scheduler
    from repro_torch.serving.engine import ServingEngine

    cfg, params, cm, mope = model
    spy = token_spy()
    sched = make_scheduler("equinox", predictor=copy.deepcopy(mope))
    eng = ServingEngine(cfg, sched, params=params, max_len=max_len,
                        cost_model=cm, seed=SEED, observer=spy,
                        keep_first_logits=True, device="cuda",
                        **engine_kw)
    finite = []
    sample = eng._sample
    prefills, decodes = [0], [0]
    whole, slots_decode = eng._prefill_whole, eng._decode_slots

    def checked_sample(row):             # every decode row's logits
        finite.append(bool(np.isfinite(row).all()))
        return sample(row)

    def counted_prefill(req):            # every whole-prompt prefill
        prefills[0] += 1
        return whole(req)

    def counted_decode(tokens):          # every slots decode step
        decodes[0] += 1
        return slots_decode(tokens)

    eng._sample = checked_sample
    eng._prefill_whole = counted_prefill
    eng._decode_slots = counted_decode
    reqs = requests(short, long_prompts) if reqs is None else reqs
    if eng.backend == "slots":
        # slot caches do not wrap for full attention: a write past
        # max_len would be dropped (a vision stack's patches take slots
        # ahead of the prompt)
        prefix = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" \
            else 0
        check(all(prefix + r.prompt_len + r.output_len + 1 <= max_len
                  for r in reqs), f"run {run}: a request outgrows "
              f"max_len {max_len}")
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check(len(done) == len(reqs), f"run {run}: {len(done)}/{len(reqs)} "
          "finished")
    for r in done:
        check(r.generated == r.output_len, f"run {run}: rid {r.rid} "
              f"generated {r.generated} of {r.output_len}")
        check(np.isfinite(r._first_row).all(), f"run {run}: rid {r.rid} "
              "first-token logits not finite")
        check(len(spy.tokens[r.rid]) >= r.output_len,
              f"run {run}: rid {r.rid} token log short")
    check(all(finite), f"run {run}: non-finite decode logits")
    for name, want in expect.items():
        got = launches[name]
        if want in ("per_layer_prefill", "per_layer_decode"):
            n = prefills[0] if want == "per_layer_prefill" else decodes[0]
            n_layers = layers_of(cfg, name)
            check(n > 0 and got == n_layers * n,
                  f"run {run}: {name} launched {got} times, not "
                  f"{n_layers} layers x {n} ({want})")
        else:
            check(got > 0 if want else got == 0,
                  f"run {run}: {name} launched {got} times")
    # whole iterations on the host clock (admission, planning, the
    # model step, sampling, bookkeeping); the step span of iter_log
    # is the model step and its copy back alone
    it = np.diff([t0] + spy.stamps)
    step = np.array([s for s, _, _ in eng.iter_log])
    # the model steps that ran prompt tokens (run A: 512-row chunks and
    # decode rows in one launch; run D: whole prompts)
    pre = np.array([(s, n) for s, n, _ in eng.iter_log if n > 0])
    prompt_tokens = sum(r.prompt_len for r in done)
    output_tokens = sum(r.generated for r in done)
    ttft = np.array([r.ttft() for r in done])
    line = {"phase": "engine", "run": run, "model": cfg.name,
            "backend": eng.backend, "chunked": eng.chunked,
            "max_len": max_len, "kv_quant": eng.kv_quant,
            "requests": len(done), "prefill_calls_whole": prefills[0],
            "slots_decode_steps": decodes[0],
            "prompt_tokens": prompt_tokens, "output_tokens": output_tokens,
            "iterations": eng.iterations, "wall_s": wall,
            "iter_ms_mean": wall / eng.iterations * 1e3,
            "iter_ms_median": float(np.median(it) * 1e3),
            "iter_ms_p90": float(np.percentile(it, 90) * 1e3),
            "prefill_tok_per_s_wall": prompt_tokens / wall,
            "output_tok_per_s_wall": output_tokens / wall,
            "model_step_ms_median": float(np.median(step) * 1e3),
            "model_step_ms_p90": float(np.percentile(step, 90) * 1e3),
            "prefill_steps": len(pre),
            "prefill_step_ms_median": float(np.median(pre[:, 0]) * 1e3),
            "prefill_step_ms_max": float(pre[:, 0].max() * 1e3),
            "prefill_rows_per_step_mean": float(pre[:, 1].mean()),
            "ttft_model_s_p50": float(np.percentile(ttft, 50)),
            "ttft_model_s_p90": float(np.percentile(ttft, 90)),
            "slot_kv_quant": cfg.kv_quant,
            "service": {k: round(v, 1) for k, v in sched.service.items()},
            "jain": jain(list(sched.service.values())),
            "preemptions": eng.n_preemptions, "launches": launches,
            "start_mem_gib": start_gib,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if eng.backend == "slots":
        by_name = defaultdict(int)
        for st in eng.cache["stages"].values():
            for name, t in st.items():
                by_name[name] += t.numel() * t.element_size()
        line["slot_cache_bytes"] = dict(by_name)
    if eng.core.prefix_cache is not None:
        st = eng.core.prefix_cache.stats
        line["prefix_cache"] = {"lookups": st.lookups, "hits": st.hits,
                                "hit_tokens": st.hit_tokens,
                                "hit_rate": st.hit_rate()}
    if reduced_of(cfg):
        line["reduced"] = reduced_of(cfg)
    emit(line)
    tokens = {r.rid: spy.tokens[r.rid] for r in done}
    firsts = {r.rid: (r.prompt_tokens, r._first_row) for r in done}
    # the hooks above tie the engine into a cycle: free its pools and
    # caches now, not at some later collection inside the next run
    del eng, checked_sample, counted_prefill, counted_decode
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, firsts, launches, line


def layers_of(cfg, kernel):
    """The layers of ``cfg`` that launch ``kernel`` once per call: Mamba-2
    layers the SSD scan, attention layers (full, local or MLA) the
    attention kernels; RecurrentGemma's RG-LRU layers launch neither."""
    want = "mamba2" if kernel.startswith("ssd_scan") else "attn"
    return sum(1 for k in cfg.layer_kinds() if k.startswith(want))


def engine_phase(torch, kernel_rows):
    from repro_torch.core import make_scheduler
    from repro_torch.serving.engine import ServingEngine


    # every kernel and variant must stay unlaunched unless a run expects
    # it: runs A, B, C, H, I, J (bf16 queries over bf16 or int8 pages),
    # D, F, G (bf16 prefill; slots decode over the caches viewed as
    # pages) and E (bf16 SSD scan) go through the tensor-core ("mma")
    # variants
    paged = {name: False for name in launch_counts() if "/" not in name}
    splitk_mma = {"paged_attention_splitk": True,
                  "paged_attention_splitk:mma": True}
    # whole-prompt prefill through flash, decode over the slot caches
    # through split-K paged attention: each once per layer and call
    slots_attn = dict(
        paged, flash_attention="per_layer_prefill",
        paged_attention_splitk="per_layer_decode",
        **{"flash_attention:mma": "per_layer_prefill",
           "paged_attention_splitk:mma": "per_layer_decode"})
    runs = {}                         # run -> its launch counts
    last = [time.perf_counter()]

    def lap(group):                   # wall seconds of a group of runs
        now = time.perf_counter()
        SECONDS[f"engine/{group}"] = now - last[0]
        last[0] = now

    llama = setup(torch, "llama2-7b")
    tok_a, first_a, runs["A"], _ = serve(torch, "A", llama, 512, False,
                                         dict(paged, **splitk_mma),
                                         backend="paged")
    tok_b, _, runs["B"], _ = serve(torch, "B", llama, 512, False,
                                   dict(paged, **splitk_mma),
                                   backend="paged", kv_quant=True)
    _, _, runs["C"], _ = serve(torch, "C", llama, 64, True,
                               dict(paged, paged_attention=True,
                                    **{"paged_attention:mma": True}),
                               backend="paged")
    # reported, not asserted: int8 pages may flip a near-tie argmax
    agree = np.mean([tok_a[rid] == tok_b[rid] for rid in tok_a])
    emit({"phase": "engine", "greedy_agreement_fp_vs_int8": float(agree)})
    tok_d, first_d, runs["D"], _ = serve(
        torch, "D", llama, MAX_LEN_SLOTS, False,
        dict(slots_attn, **{"paged_attention_splitk/bf16": "per_layer_decode",
                            "paged_attention_splitk/int8": False}),
        backend="slots", chunked=False)
    first_token_check(first_d, first_a, "D vs A")
    dense_check(torch, llama[1], llama[0], first_a)
    # run L: D with int8 slot caches and their scales (cfg.kv_quant): the
    # same weights, requests, cost model and predictor; decode through
    # split-K over int8 pools
    quant = (dataclasses.replace(llama[0], kv_quant=True),) + llama[1:]
    tok_l, first_l, runs["L"], _ = serve(
        torch, "L", quant, MAX_LEN_SLOTS, False,
        dict(slots_attn, **{"paged_attention_splitk/int8": "per_layer_decode",
                            "paged_attention_splitk/bf16": False}),
        backend="slots", chunked=False)
    # prefill does not read the caches: L's first tokens are D's
    first_token_check(first_l, first_d, "L vs D")
    # reported, not asserted: int8 caches may flip a near-tie argmax
    emit({"phase": "engine", "greedy_agreement_D_vs_L": float(np.mean(
        [tok_d[rid] == tok_l[rid] for rid in tok_d]))})
    runs["J"] = cluster_run(torch, llama, dict(paged, **splitk_mma))

    def profiled(run, model, max_len, window="decode", long_prompts=0,
                 **engine_kw):
        cfg, params, cm, mope = model
        return profile_window(torch, run, ServingEngine(
            cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
            params=params, max_len=max_len, cost_model=cm, seed=SEED,
            device="cuda", **engine_kw), requests(False, long_prompts),
            window)

    # (the prefill windows of A and D were cut for run Z's time)
    profiled("A", llama, 512, backend="paged")
    no_casts("D", profiled("D", llama, MAX_LEN_SLOTS, backend="slots",
                           chunked=False))
    no_casts("L", profiled("L", quant, MAX_LEN_SLOTS, backend="slots",
                           chunked=False))
    del llama, quant
    torch.cuda.empty_cache()
    lap("A-D,J,L")

    mamba = setup(torch, "mamba2-2.7b")
    _, _, runs["E"], _ = serve(torch, "E", mamba, MAX_LEN_SLOTS, False,
                               dict(paged, ssd_scan="per_layer_prefill",
                                    **{"ssd_scan:mma": "per_layer_prefill"}),
                               backend="slots")
    decode_consistency(torch, mamba[1], mamba[0])
    profiled("E", mamba, MAX_LEN_SLOTS, backend="slots")
    profiled("E", mamba, MAX_LEN_SLOTS, "prefill", backend="slots")
    del mamba
    gc.collect()
    torch.cuda.empty_cache()
    lap("E")

    # the MoE stacks: whole-prompt prefill through the flash kernel,
    # decode through the paged kernels over the slot caches
    deepseek = setup(torch, "deepseek-moe-16b")
    _, first_f, runs["F"], _ = serve(torch, "F", deepseek, MAX_LEN_SLOTS,
                                     False, slots_attn, backend="slots",
                                     chunked=False)
    # one prompt at a time: the plain forward's dispatch sees the same
    # rows as the served prefill, so the same assignments drop
    dense_check(torch, deepseek[1], deepseek[0], first_f)
    # prefill and decode put different row counts through the dispatch,
    # which then drops different assignments: compare on the dense path
    decode_consistency(torch, deepseek[1], dataclasses.replace(
        deepseek[0], moe_impl="dense"))
    no_casts("F", profiled("F", deepseek, MAX_LEN_SLOTS, backend="slots",
                           chunked=False))
    del deepseek
    gc.collect()
    torch.cuda.empty_cache()
    lap("F")

    mixtral = setup(torch, "mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    window = mixtral[0].window
    _, first_g, runs["G"], _ = serve(torch, "G", mixtral, MAX_LEN_LONG,
                                     False, slots_attn, long_prompts=2,
                                     backend="slots")
    long = sorted(rid for rid, (toks, _) in first_g.items()
                  if len(toks) > window)
    check(len(long) == 2, f"run G: {len(long)} prompts past the window "
          f"{window}, not 2")
    dense_check(torch, mixtral[1], mixtral[0], first_g, rids=long[:1])
    decode_consistency(torch, mixtral[1], dataclasses.replace(
        mixtral[0], moe_impl="dense"), n=window + 104)
    line = profiled("G", mixtral, MAX_LEN_LONG, "prefill", long_prompts=2,
                    backend="slots")
    check(line["longest_prompt_prefilled"] > window, "run G: the prefill "
          "window carried no prompt past the attention window")
    no_casts("G", profiled("G", mixtral, MAX_LEN_LONG, long_prompts=2,
                           backend="slots"))
    del mixtral
    gc.collect()
    torch.cuda.empty_cache()
    lap("G")

    # StarCoder2-7B: G = 9 through the paged kernels at full width
    starcoder = setup(torch, "starcoder2-7b")
    _, first_h, runs["H"], _ = serve(torch, "H", starcoder, 512, False,
                                     dict(paged, **splitk_mma),
                                     backend="paged")
    dense_check(torch, starcoder[1], starcoder[0], first_h)
    line = profiled("H", starcoder, 512, backend="paged")
    walks = " ".join(line["port_kernels_ms_per_iteration"])
    check("paged_attention_mma_kernel<128, false, false>" in walks
          and "paged_attention_mma_kernel<128, false, true>" not in walks,
          f"run H: decode rows of a G = 9 stack must take the tensor-core "
          f"walk and never the one-row walk; kernels: {walks}")
    runs["I (cold)"], runs["I (warm)"] = prefix_cache_run(
        torch, starcoder, dict(paged, **splitk_mma))
    del starcoder
    gc.collect()
    torch.cuda.empty_cache()
    lap("H,I")

    # MiniCPM3-4B: MLA, whole-prompt prefill through flash at D = 96 /
    # Dv = 64, absorbed latent decode (torch.bmm, no paged kernel); run
    # C's short requests (prompts of 16-39 tokens, outputs under 64: cut
    # for run Z's time), its decode window on the 12 long ones
    minicpm = setup(torch, "minicpm3-4b")
    _, first_k, runs["K"], _ = serve(
        torch, "K", minicpm, MAX_LEN_SLOTS, True,
        dict(paged, flash_attention="per_layer_prefill",
             **{"flash_attention:mma": "per_layer_prefill"}),
        backend="slots", chunked=False)
    n_flash = minicpm[0].n_layers * len(first_k)
    check(runs["K"]["flash_attention:mma"] == n_flash,
          f"run K: flash_attention:mma launched "
          f"{runs['K']['flash_attention:mma']} times, not {n_flash}")
    dense_check(torch, minicpm[1], minicpm[0], first_k)
    decode_consistency(torch, minicpm[1], minicpm[0])
    line = profiled("K", minicpm, MAX_LEN_SLOTS, backend="slots",
                    chunked=False)
    no_casts("K", line, paged=False)
    check(line["wkv_b_slice_copies_per_iteration"] == 0, f"run K: a decode "
          f"iteration copied W_UK or W_UV "
          f"{line['wkv_b_slice_copies_per_iteration']} times")
    del minicpm
    gc.collect()
    torch.cuda.empty_cache()
    lap("K")

    # RecurrentGemma-2B: 18 RG-LRU layers (PyTorch operations, no kernel)
    # beside 8 local-attention layers of 10 query heads over one kv head
    # of 256: whole-prompt prefill through flash at D = 256, decode over
    # the 2048-slot rings through split-K; two prompts past the window
    rgemma = setup(torch, "recurrentgemma-2b")
    window = rgemma[0].window
    _, first_m, runs["M"], _ = serve(
        torch, "M", rgemma, MAX_LEN_LONG, False,
        dict(slots_attn, **{"paged_attention_splitk/bf16": "per_layer_decode",
                            "paged_attention_splitk/int8": False}),
        long_prompts=2, backend="slots", chunked=False)
    long = sorted(rid for rid, (toks, _) in first_m.items()
                  if len(toks) > window)
    check(len(long) == 2, f"run M: {len(long)} prompts past the window "
          f"{window}, not 2")
    short = [rid for rid in sorted(first_m) if rid not in long]
    dense_check(torch, rgemma[1], rgemma[0], first_m,
                rids=long[:1] + short[:1])
    decode_consistency(torch, rgemma[1], rgemma[0], n=window + 104)
    line = profiled("M", rgemma, MAX_LEN_LONG, "prefill", long_prompts=2,
                    backend="slots", chunked=False)
    check(line["longest_prompt_prefilled"] > window, "run M: the prefill "
          "window carried no prompt past the attention window")
    no_casts("M", profiled("M", rgemma, MAX_LEN_LONG, long_prompts=2,
                           backend="slots", chunked=False))
    del rgemma
    gc.collect()
    torch.cuda.empty_cache()
    lap("M")

    # Whisper large-v3: the encoder and cross-attention through flash
    # (Sq != Skv), decode through split-K over pages of 16 and of 4
    runs["N"] = whisper_run(torch)
    lap("N")

    # InternVL2-76B (32 of 80 layers): 256 stubbed patches ahead of every
    # prompt, whole-prompt prefill through flash at Sq = 256 + prompt,
    # decode through split-K over the slot caches from prompt + 256
    vlm = setup(torch, "internvl2-76b", n_layers=INTERNVL_LAYERS)
    runs["O"] = internvl_run(torch, vlm, slots_attn)
    no_casts("O", profiled("O", vlm, MAX_LEN_VLM, backend="slots",
                           chunked=False))
    del vlm
    gc.collect()
    torch.cuda.empty_cache()
    lap("O")

    # Granite-3-2B training at full width and depth: flash forward (with
    # lse) and its recompute under remat, the flash backward kernel
    runs["P"] = train_run(torch)
    lap("P")
    # the MoE, MLA, encoder-decoder and RG-LRU stacks trained
    for run in TRAIN_RUNS:
        runs[run] = stack_train_run(torch, run)
        lap(run)
    # run V: run P through train(mesh=...) on a (1, 1) DeviceMesh over
    # NCCL; runs W, X and Y: two rank processes on the card, the weights
    # gathered at use (Y: the RG-LRU branch channel-parallel); then the
    # ring, forward and backward, over V's mesh and over 8 shards in one
    # process
    runs["V"] = mesh_train_run(torch)
    lap("V")
    for run in MESH_RUNS:
        runs[run] = mesh_rank_run(torch, run)
        lap(run)
    # run Z: serving over a (1, 2) mesh of two rank processes, heads,
    # experts and vocab split over "model"
    runs["Z"] = serve_mesh_run(torch)
    lap("Z")
    (runs["ring"], kernel_rows["flash_attention"]["ring_shapes"],
     kernel_rows["flash_attention_bwd"]["ring_shapes"]) = ring_phase(torch)
    torch.distributed.destroy_process_group()
    lap("ring")

    emit({"phase": "engine", "launches_by_run": {
        run: {k: n for k, n in r.items() if n} for run, r in runs.items()}})
    for name, row in kernel_rows.items():
        row["launches"] = sum(r[name] for r in runs.values())
        variants = {k.split(":")[1]: sum(r[k] for r in runs.values())
                    for k in runs["A"] if k.startswith(f"{name}:")}
        if variants:
            row["launches_by_variant"] = variants
        pools = {k.split("/")[1]: sum(r[k] for r in runs.values())
                 for k in runs["A"] if k.startswith(f"{name}/")}
        if pools:
            row["launches_by_pools"] = pools


def examples_phase(torch):
    """The port's engine examples run on the card through their
    ``main()``: ``examples/quickstart_torch.py`` (MoPE trained, a reduced
    Llama-2 served under Equinox: 12 requests of two clients) and
    ``examples/serve_multiarch_torch.py`` (every registered architecture's
    smoke config behind ``ServingEngine``, 6 requests each, the
    encoder-decoder refused by the engine).  Each one's seconds and
    launches go on the ``examples`` line (outside every run's counts)."""
    import importlib.util

    out = {}
    for name in ("quickstart_torch", "serve_multiarch_torch"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launch_counts()
        t0 = time.perf_counter()
        result = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        SECONDS[f"examples/{name}"] = time.perf_counter() - t0
        out[name] = {"seconds": SECONDS[f"examples/{name}"],
                     "result": result,
                     "launches": {k: v for k, v in launch_counts().items()
                                  if v}}
    quick = out["quickstart_torch"]["result"]
    check(quick["requests"] == 12 and np.isfinite(quick["jain"]),
          f"examples: quickstart_torch served {quick}")
    multi = out["serve_multiarch_torch"]["result"]
    skipped = [a for a, v in multi.items() if v is None]
    check(skipped == ["whisper-large-v3"] and all(
        ok == n for v in multi.values() if v is not None for ok, n in [v]),
        f"examples: serve_multiarch_torch served {multi}")
    emit({"phase": "examples", **out})
    reset_launch_counts()


def internvl_run(torch, vlm, slots_attn):
    """Run O: InternVL2-76B at full width (d_model 8192, 64 query heads
    over 8 kv heads of 128, d_ff 28 672, vocab 128 256, untied, bf16;
    random weights from SEED), depth cut to INTERNVL_LAYERS of 80, on the
    slots engine with whole-prompt prefill, max_len MAX_LEN_VLM: the 12
    requests of runs A-M, each with the engine's 256 stubbed patches
    ahead of its prompt.  Checks: 12/12 served; flash once per layer and
    prefill, each at Sq = 256 + the prompt; split-K once per layer and
    decode step, over bf16 pools; first tokens against a plain forward
    over the same patches and tokens; decode consistency after the
    prefix.  ``vlm``: ``setup``'s model.  Returns the run's launch
    counts."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = vlm[0]
    P = cfg.n_frontend_tokens
    seen = []                            # Sq of every flash launch
    launch = fa._flash_cuda

    def spy(q, *a, **kw):
        seen.append(q.shape[1])
        return launch(q, *a, **kw)

    fa._flash_cuda = spy
    try:
        _, first_o, launches, line = serve(
            torch, "O", vlm, MAX_LEN_VLM, False,
            dict(slots_attn, **{"paged_attention_splitk/bf16":
                                "per_layer_decode",
                                "paged_attention_splitk/int8": False}),
            backend="slots", chunked=False)
    finally:
        fa._flash_cuda = launch
    want = Counter()
    for toks, _ in first_o.values():
        want[P + len(toks)] += cfg.n_layers
    check(Counter(seen) == want, f"run O: flash launched at Sq "
          f"{sorted(set(seen))}, not at {P} + each prompt, {cfg.n_layers} "
          "times each")
    emit({"phase": "engine", "run": "O", "flash_sq": sorted(set(seen)),
          "vision_prefix": P, "flash_launches": len(seen)})
    dense_check(torch, vlm[1], cfg, first_o)
    decode_consistency(torch, vlm[1], cfg)
    return launches


def train_launches(cfg, steps):
    """The flash and SSD-scan forward and backward launches ``steps``
    training steps (or loss gradients) of ``cfg`` make: each attention
    call of a layer, and each Mamba-2 layer's scan, once forward and once
    backward, a decoder layer's forward once more under remat (its
    recompute); an encoder-decoder's decoder layers attend twice (self
    and cross), its encoder layers once, without remat."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2

    kinds = cfg.layer_kinds()
    n_attn = sum(k in (ATTN, ATTN_LOCAL, ATTN_MLA) for k in kinds)
    n_attn *= 2 if cfg.is_encoder_decoder else 1
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    n_ssd = sum(k == MAMBA2 for k in kinds)
    per = 2 if cfg.remat else 1
    fwd = steps * (n_enc + per * n_attn)
    bwd = steps * (n_enc + n_attn)
    return {"flash_attention": fwd, "flash_attention:mma": fwd,
            "flash_attention_bwd": bwd, "flash_attention_bwd:mma": bwd,
            "ssd_scan": steps * per * n_ssd,
            "ssd_scan:mma": steps * per * n_ssd,
            "ssd_scan_bwd": steps * n_ssd,
            "ssd_scan_bwd:mma": steps * n_ssd}


@contextlib.contextmanager
def plain_ssd():
    """Mamba-2 layers through the SSD scan's plain version (the step-0
    loss check's reference, beside ``attn_impl="naive"``); nothing in
    the package has a switch for it."""
    ssm = importlib.import_module("repro_torch.models.ssm")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    kernel = ssm.ssd_scan_kernel
    ssm.ssd_scan_kernel = ss.ssd_scan_plain
    try:
        yield
    finally:
        ssm.ssd_scan_kernel = kernel


def train_check(torch, run, cfg, tc, reduced=None, aux=False):
    """One training run: weights drawn on the card from SEED,
    ``training.train`` over ``tc``, and its checks: step 0's loss within
    TRAIN_LOSS_TOL of ``loss_fn`` with the plain attention
    (``attn_impl="naive"``) and the SSD scan's plain version
    (``plain_ssd``) on the same weights and batch (an encoder-decoder's
    with the frames ``train`` draws for step 0), the loss after the last
    step below step 0's, the flash and SSD-scan forward and backward
    launched as ``train_launches`` derives and nothing else of the
    port.  Emits the ``train`` line (step times, the median after the
    first, tokens/s, peak memory; ``aux``: step 0's MoE load-balance loss
    from ``forward_hidden``).  Returns (params, launches, step 0's batch
    on the card)."""
    from repro_torch.models.model import forward_hidden, loss_fn
    from repro_torch.training import train
    from repro_torch.training.data import batches
    from repro_torch.training.trainer import STUB_INPUTS, stub_embeddings
    from repro_torch.weights import init_params

    check(cfg.remat and cfg.attn_impl == "flash" and cfg.dtype == "bfloat16",
          f"run {run}: {cfg.name} is not a bf16 flash stack with remat")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    setup_line = {"phase": "engine_setup", "run": run, "model": cfg.name,
                  "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                  "dtype": cfg.dtype, "n_params": cfg.n_params(),
                  "weight_gib": sum(t.numel() * t.element_size()
                                    for t in _leaves(params)) / 2 ** 30,
                  "init_s": time.perf_counter() - t0}
    if reduced:
        setup_line["reduced"] = reduced
    emit(setup_line)
    t0 = time.perf_counter()
    b0 = next(batches(cfg.vocab_size, tc.batch, tc.seq_len, 1, tc.seed))
    stub = STUB_INPUTS.get(cfg.frontend)
    if stub:
        b0[stub] = stub_embeddings(cfg, tc, 0)
    data_s = time.perf_counter() - t0
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    with torch.no_grad(), plain_ssd():
        plain_loss = float(loss_fn(params, b0, dataclasses.replace(
            cfg, attn_impl="naive")))
        aux0 = float(forward_hidden(params, b0, cfg)[1]) if aux else None
    torch.cuda.empty_cache()
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = train(cfg, tc, params=params, device="cuda",
                           log=lambda msg: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = np.diff([t0] + stamps) * 1e3
    want = {name: 0 for name in launches}
    want.update(train_launches(cfg, tc.steps))
    loss = [v for _, v in losses]
    tokens = tc.batch * tc.seq_len
    line = {"phase": "train", "run": run, "model": cfg.name,
            "entry": "training.train", "n_layers": cfg.n_layers,
            "batch": tc.batch, "seq_len": tc.seq_len, "steps": tc.steps,
            "remat": cfg.remat, "losses": loss,
            "plain_attention_step0_loss": plain_loss,
            "step0_loss_err": abs(loss[0] - plain_loss), "wall_s": wall,
            "step_ms": list(steps), "step_ms_median_after_first":
                float(np.median(steps[1:])),
            "tokens_per_s": tokens / float(np.median(steps[1:])) * 1e3,
            "data_ms_per_batch": data_s * 1e3,
            "launches": {k: v for k, v in launches.items() if v},
            "start_mem_gib": start_gib, "peak_mem_gib": peak,
            "device_mem_gib": torch.cuda.get_device_properties(
                0).total_memory / 2 ** 30}
    if stub:
        line[f"{stub}_per_step"] = list(b0[stub].shape)
    if aux:
        line["step0_aux"] = aux0
    if reduced:
        line["reduced"] = reduced
    TRAIN_LINES[run] = line
    emit(line)
    check(len(loss) == tc.steps and all(np.isfinite(loss)),
          f"run {run}: losses {loss}")
    check(abs(loss[0] - plain_loss) <= TRAIN_LOSS_TOL, f"run {run}: step "
          f"0's loss {loss[0]} is {abs(loss[0] - plain_loss)} from the "
          f"plain attention's {plain_loss}")
    check(loss[-1] < loss[0], f"run {run}: the loss did not fall: {loss}")
    check(launches == want, f"run {run}: launches "
          f"{ {k: v for k, v in launches.items() if v} }, not "
          f"{ {k: v for k, v in want.items() if v} }")
    if aux:
        check(np.isfinite(aux0) and aux0 > 0, f"run {run}: aux {aux0}")
    return params, launches, b0


def train_run(torch):
    """Run P: Granite-3-2B as registered (40 layers, d_model 2048, 32
    query heads over 8 kv heads of 64, d_ff 8192, vocab 49 155, tied,
    bf16, remat per layer; random weights from SEED) trained at full
    width and depth by ``training.train``: TRAIN's 8 AdamW steps on
    batches of 4 x 2048 tokens of the synthetic Markov stream, checked by
    ``train_check``: flash forward launched 2 x 40 x 8 times (the
    forward and its recompute under remat), the backward's ``mma``
    variant 40 x 8 (the backward kernel at a layer's shapes is held to
    its plain version in the kernel phase: ``granite_B4_S2048_gqa4_d64``).
    Then one profiled step, with the device ms of the ``adamw_update``
    label and of the backward's kernels, and the update profiled alone.
    Returns the run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.training import TrainConfig

    cfg = get_config("granite-3-2b")
    tc = TrainConfig(**TRAIN)
    params, launches, _ = train_check(torch, "P", cfg, tc)
    tokens = tc.batch * tc.seq_len

    # one more step under the profiler (a fresh optimizer state)
    prof, wall_ms, opt, state = profiled_train_step(torch, cfg, tc, params)
    # the optimizer's share, beside the backward's: the device time of
    # the kernels launched under AdamW.update's record_function label,
    # and the update alone, profiled by itself (the parameters stand in
    # for their gradients: the same leaves, the same kernels).  The
    # label's sum has read 177 to 328 ms between calls whose kernels
    # summed the same, the update alone 177: the second is the measure.
    adamw = adamw_label(prof)
    summary = profile_summary(prof, 1, wall_ms)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_alone:
        opt.update(params, state, params)
        torch.cuda.synchronize()
    alone = profile_summary(prof_alone, 1, (time.perf_counter() - t0) * 1e3)
    emit({"phase": "profile", "run": "P", "window": "train_step",
          "iterations": 1, "rows_per_iteration": tokens, **summary,
          "adamw_update_device_ms": adamw_ms(adamw),
          "adamw_update_alone_device_ms": alone["device_ms_per_iteration"],
          "adamw_update_alone_launches": alone[
              "kernel_launches_per_iteration"],
          "flash_bwd_device_ms": sum(
              ms for name, ms in summary[
                  "port_kernels_ms_per_iteration"].items()
              if "flash_bwd" in name)})
    check(adamw, "run P: no adamw_update label in the profiled step")
    del params, state, opt, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profiled_train_step(torch, cfg, tc, params):
    """One more AdamW step of ``cfg`` after a run of ``tc`` (a fresh
    optimizer state, the batch of seed ``tc.seed + 1``) under the
    profiler: (profiler, host ms of the step, optimizer, its state)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import AdamW, cosine_schedule, make_train_step
    from repro_torch.training.data import batches

    opt = AdamW(lr=cosine_schedule(tc.peak_lr, tc.warmup, tc.steps),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    b1 = {k: torch.from_numpy(v).to("cuda") for k, v in next(batches(
        cfg.vocab_size, tc.batch, tc.seq_len, 1, tc.seed + 1)).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, b1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms, opt, state


def adamw_label(prof):
    """The host events of ``AdamW.update``'s record_function label."""
    return [e for e in prof.key_averages() if e.key == "adamw_update"
            and str(e.device_type).endswith("CPU")]


def adamw_ms(events):
    """Device ms of the kernels launched under the label's events."""
    return sum(getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
               for e in events) / 1e3


# classes of device kernels by name (the first class whose key is in a
# kernel's name takes it), for a profiled step's breakdown
KERNEL_CLASSES = (("ssd_backward", ("ssd_bwd",)),
                  ("ssd_forward", ("ssd_scan",)),
                  ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("copy", ("copy", "Memcpy", "Memset", "CatArray")),
                  ("conv", ("conv",)), ("reduce", ("reduce",)),
                  ("elementwise", ("elementwise",)))


def device_ms_by_class(prof, steps=1):
    """A profiled window's device ms per iteration by KERNEL_CLASSES
    (``other`` for the rest), with the number of kernels of each."""
    out = defaultdict(lambda: [0.0, 0.0])
    for e in device_kernels(prof):
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.key for k in keys)), "other")
        out[cls][0] += device_us(e) / 1e3 / steps
        out[cls][1] += e.count / steps
    return {c: {"ms": v[0], "launches": v[1]}
            for c, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def stack_train_run(torch, run):
    """Runs Q-T: the MoE, MLA, encoder-decoder and RG-LRU stacks trained
    by ``training.train`` at full width, TRAIN_QT's 4 AdamW steps each on
    random weights from SEED, checked by ``train_check`` (TRAIN_RUNS has
    each run's model, depth, batch and launches):

    Q  DeepSeek-MoE-16B, 7 of 28 layers (1 dense + 6 MoE: 4.03 B
       parameters, ~48 GB of weights, gradients and f32 moments; all 28
       need ~196 GB; 8 do not fit), registered with ``moe_impl=
       "dispatch"`` at capacity factor 1.0, so assignments past an
       expert's capacity drop; 4 x 2048 tokens; flash 2 x 7 x 4 = 56,
       backward 28.  Also step 0's aux loss, and
       whether two gradients of the same loss on the same batch are
       equal bit for bit (the gathers' gradients accumulate by index);
    R  MiniCPM3-4B, all 62 layers (4.26 B parameters), MLA: flash at D =
       96 / Dv = 64; 4 x 2048 tokens; flash 496, backward 248;
    S  Whisper large-v3, all 32 + 32 layers (1.60 B parameters), 8 x 448
       tokens over 1500 stubbed frames a row; the encoder runs without
       remat, so flash 4 x (32 + 2 x 64) = 640, backward 4 x 96 = 384
       (the cross-attention at Sq 448, Skv 1500);
    T  RecurrentGemma-2B, all 26 layers (3.31 B parameters), 2 x 4096
       tokens, so the 2048 window cuts; 8 local-attention layers at head
       dim 256: flash 64, backward 32 (the 18 RG-LRU layers launch no
       kernel of the port);
    U  Mamba-2-2.7B, all 64 layers (2.83 B parameters), 4 x 2048 tokens:
       the SSD scan 2 x 64 x 4 = 512 (the forward and its recompute under
       remat, each writing its chunk states), the SSD backward kernel
       64 x 4 = 256, no flash; step 0's loss against the plain scan's.
       Also whether two gradients of one batch are equal bit for bit (the
       backward has no atomics), with those two gradients' launches
       (2 x 128 forward, 2 x 64 backward) checked as derived; then one
       more step profiled (a fresh optimizer state): device ms by kernel
       and by class of kernel, the busy share.

    Returns the run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import loss_fn
    from repro_torch.training import TrainConfig

    arch, n_layers, batch, seq_len = TRAIN_RUNS[run]
    cfg = get_config(arch)
    if cfg.moe is not None:
        check(cfg.moe_impl == "dispatch" and cfg.moe.capacity_factor == 1.0,
              f"{run}: {arch} is registered with moe_impl {cfg.moe_impl!r} "
              f"at capacity factor {cfg.moe.capacity_factor}, not the "
              "dispatch at 1.0")
    reduced = None
    if n_layers is not None:
        full = cfg.n_params()
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        reduced = {"n_layers": [get_config(arch).n_layers, n_layers],
                   "n_params": [full, cfg.n_params()],
                   "why": "a step holds ~12 bytes a parameter (bf16 weights "
                          "and gradients, f32 moments) plus the optimizer's "
                          "f32 temporaries: the deepest stack that fits the "
                          "card (on an H100 80GB, 7 layers peaked at 65.8 "
                          "GiB and 8 ran out of memory)"}
    tc = TrainConfig(**dict(TRAIN_QT, batch=batch, seq_len=seq_len))
    params, launches, b0 = train_check(torch, run, cfg, tc, reduced,
                                       aux=cfg.moe is not None)
    ssm = cfg.ssm is not None
    if cfg.moe is not None or ssm:
        # two gradients of one loss on one batch, bit for bit
        leaves = list(_leaves(params))
        first = None
        reset_launch_counts()
        for _ in range(2):
            loss = loss_fn(params, b0, cfg)
            grads = torch.autograd.grad(loss, leaves)
            if first is None:
                first = (loss.detach(), grads)
        torch.cuda.synchronize()
        counts = launch_counts()
        same = [bool(torch.equal(a, b)) for a, b in zip(first[1], grads)]
        line = {"phase": "train", "run": run, "check": "determinism",
                "loss_bitwise_equal": bool(torch.equal(first[0], loss)),
                "grad_leaves": len(same), "grad_leaves_bitwise_equal":
                    sum(same)}
        if ssm:
            line["launches"] = {k: v for k, v in counts.items() if v}
        emit(line)
        if ssm:
            want = {name: 0 for name in counts}
            want.update(train_launches(cfg, 2))
            check(counts == want, f"run {run}: two gradients launched "
                  f"{line['launches']}, not "
                  f"{ {k: v for k, v in want.items() if v} }")
        del first, grads, loss
    if ssm:
        # one more step under the profiler: where the step's time goes
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        prof, wall_ms, opt, state = profiled_train_step(torch, cfg, tc,
                                                        params)
        summary = profile_summary(prof, 1, wall_ms)
        emit({"phase": "profile", "run": run, "window": "train_step",
              "iterations": 1, "rows_per_iteration": tc.batch * tc.seq_len,
              **summary, "device_ms_by_class": device_ms_by_class(prof),
              "adamw_update_device_ms": adamw_ms(adamw_label(prof)),
              "profile_s": time.perf_counter() - t0})
        del prof, opt, state
    del params, b0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mesh_train_run(torch):
    """Run V: run P (Granite-3-2B, TRAIN's 8 steps of 4 x 2048, the same
    weights from SEED and the same batches) through
    ``training.train(cfg, tc, mesh=make_host_mesh())``: a (1, 1)
    ``("data", "model")`` DeviceMesh over NCCL at world size 1 (the
    process group started from an in-process store), the parameters cut
    by ``param_specs`` (``ShardPlan``: at world size 1 every leaf stays
    itself, nothing is gathered or reduced), each batch's rows by
    ``batch_specs``.  Its losses must equal P's bit
    for bit and its launches P's (``train_launches``); the ``train`` line
    carries P's step time, tokens/s and peak beside V's.  Returns the
    run's launch counts."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import TrainConfig, train
    from repro_torch.weights import init_params

    p_line = TRAIN_LINES["P"]
    cfg = get_config("granite-3-2b")
    tc = TrainConfig(**TRAIN)
    mesh = make_host_mesh()
    mesh_desc = {"shape": list(mesh.shape),
                 "axes": list(mesh.mesh_dim_names),
                 "backend": dist.get_backend(),
                 "world_size": dist.get_world_size()}
    check(mesh_desc == {"shape": [1, 1], "axes": ["data", "model"],
                        "backend": "nccl", "world_size": 1},
          f"run V: host mesh {mesh_desc}")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = train(cfg, tc, mesh=mesh, params=params, device="cuda",
                           log=lambda msg: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = np.diff([t0] + stamps) * 1e3
    want = {name: 0 for name in launches}
    want.update(train_launches(cfg, tc.steps))
    loss = [v for _, v in losses]
    median = float(np.median(steps[1:]))
    emit({"phase": "train", "run": "V", "model": cfg.name,
          "entry": "training.train(mesh=launch.mesh.make_host_mesh())",
          "mesh": mesh_desc, "n_layers": cfg.n_layers, "batch": tc.batch,
          "seq_len": tc.seq_len, "steps": tc.steps, "losses": loss,
          "losses_bitwise_equal_P": loss == p_line["losses"],
          "wall_s": wall, "step_ms": list(steps),
          "step_ms_median_after_first": median,
          "tokens_per_s": tc.batch * tc.seq_len / median * 1e3,
          "peak_mem_gib": peak,
          "launches": {k: v for k, v in launches.items() if v},
          "P": {k: p_line[k] for k in ("step_ms_median_after_first",
                                       "tokens_per_s", "peak_mem_gib")}})
    check(loss == p_line["losses"], f"run V: losses {loss} are not run "
          f"P's {p_line['losses']} bit for bit")
    check(launches == want, f"run V: launches "
          f"{ {k: v for k, v in launches.items() if v} }, not "
          f"{ {k: v for k, v in want.items() if v} }")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mesh_run_config(run):
    """(cfg, TrainConfig, (data, model), reduced or None, steps run) of
    run W, X or Y."""
    from repro_torch.configs import get_config
    from repro_torch.training import TrainConfig

    arch, n_layers, shape, train_kw, fields, steps = MESH_RUNS[run]
    cfg = get_config(arch)
    reduced = None
    if n_layers is not None:
        full = cfg.n_params()
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        alone = {"X": "run Q's 7 layers peaked at 65.8 GiB alone",
                 "Y": "run T's 26 layers peaked at 52.09 GiB alone"}[run]
        reduced = {"n_layers": [get_config(arch).n_layers, n_layers],
                   "n_params": [full, cfg.n_params()],
                   "why": "two rank processes and the single-process "
                          f"baseline share one card: {alone}"}
    return (dataclasses.replace(cfg, **fields), TrainConfig(**train_kw),
            shape, reduced, steps)


@contextlib.contextmanager
def first_steps(steps):
    """``training.train`` runs only the first ``steps`` of its
    TrainConfig's (the batches cut; the learning-rate schedule the whole
    run's)."""
    import itertools

    trainer = importlib.import_module("repro_torch.training.trainer")
    batches = trainer.batches
    trainer.batches = lambda *a, **kw: itertools.islice(batches(*a, **kw),
                                                        steps)
    try:
        yield
    finally:
        trainer.batches = batches


def mesh_rank_main(argv) -> int:
    """One rank process of run W, X or Y (``--rank RUN RANK WORLD STORE
    OUT``): joins the group over the ``FileStore`` STORE
    (``launch.mesh.join_ranks``: gloo, the ranks sharing the card), trains
    the run's config by ``training.train(cfg, tc, mesh=...)`` on its
    (data, model) mesh from SEED's weights, and writes its losses, step
    times, peak memory, launches, the transport, the collectives its
    plan counted at every step (``ShardPlan.counted``, read from the
    ``MeshTrainer`` that ``train`` made, at each step's log) beside the
    schedule's a step, and, in run W, each collective kind's time alone
    (``transport_rates``), in run Y the widths ``linear_scan`` saw and the
    RG-LRU leaves' gathers and local splits, to OUT (JSON)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import step_collectives
    from repro_torch.launch.mesh import join_ranks, make_host_mesh
    from repro_torch.models import rglru
    from repro_torch.training import train, trainer
    from repro_torch.weights import init_params

    made = []

    class RecordedMeshTrainer(trainer.MeshTrainer):
        """``train``'s MeshTrainer, kept so its plan's counts are read."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    trainer.MeshTrainer = RecordedMeshTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    backend = join_ranks(store, rank, world, "cuda")
    widths, scan = set(), rglru.linear_scan

    def spy(a, b, *args, **kw):
        widths.add(a.shape[-1])
        return scan(a, b, *args, **kw)

    rglru.linear_scan = spy
    try:
        cfg, tc, (_, model), _, n_steps = mesh_run_config(run)
        mesh = make_host_mesh(model=model)
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stamps, counted = [], []

        def log(msg):
            stamps.append(time.perf_counter())
            comm = made[0].plan.comm
            counted.append({"bytes": dict(comm.bytes),
                            "counts": dict(comm.counts)})

        reset_launch_counts()
        t0 = time.perf_counter()
        with first_steps(n_steps):
            params, losses = train(cfg, tc, mesh=mesh, params=params,
                                   device="cuda", log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        steps = np.diff([t0] + stamps) * 1e3
        coll = step_collectives(cfg, ShapeConfig(
            "mesh", tc.seq_len, tc.batch, "train"), mesh)
        zero = {k: dict.fromkeys(v, 0) for k, v in counted[0].items()}
        per_step = [{k: {kind: b[k][kind] - a[k][kind] for kind in b[k]}
                     for k in b} for a, b in zip([zero] + counted, counted)]
        plan = made[0].plan
        line = {"rank": rank, "backend": backend,
                "mesh": {"shape": list(mesh.shape),
                         "axes": list(mesh.mesh_dim_names)},
                "losses": [v for _, v in losses], "wall_s": wall,
                "step_ms": list(steps),
                "step_ms_median_after_first": float(np.median(steps[1:])),
                "shard_gib": sum(t.numel() * t.element_size()
                                 for t in _leaves(params)) / 2 ** 30,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": launches,
                "collectives_counted": {"bytes": dict(plan.comm.bytes),
                                        "counts": dict(plan.comm.counts)},
                "collectives_counted_by_step": per_step,
                "schedule_per_step": {"bytes": coll["bytes"],
                                      "counts": coll["counts"]}}
        if plan.channel_stages:
            branch = [leaf for leaf in plan.leaves
                      if leaf.path[1] in plan.channel_stages
                      and leaf.path[2] == "attn"]
            line["channel_parallel"] = {
                "linear_scan_widths": sorted(widths),
                "rglru_leaves": len(branch),
                "rglru_leaves_gathered_over_model": [
                    "/".join(leaf.path) for leaf in branch
                    if any(axis == "model" for _, axis in leaf.steps)],
                "rglru_leaves_local": sum(leaf.local == ("model",)
                                          for leaf in branch),
                "branch_schedule_per_step": plan.channel_schedule(
                    tc.batch * tc.seq_len)}
        if run == "W":
            line["transport_rates"] = transport_rates(torch, dist)
        with open(out, "w") as f:
            json.dump(line, f)
    finally:
        rglru.linear_scan = scan
        dist.destroy_process_group()
    return 0


def transport_rates(torch, dist):
    """Seconds a call and GB/s of input of the default group's
    all_gather_into_tensor, reduce_scatter_tensor and all_reduce alone,
    on bf16 CUDA tensors of TRANSPORT_MIB MiB of input (the mean of
    TRANSPORT_REPS calls after one), every rank calling together."""
    n = (TRANSPORT_MIB << 20) // 2
    world = dist.get_world_size()
    x = torch.ones(n, device="cuda", dtype=torch.bfloat16)
    gathered = torch.empty(world * n, device="cuda", dtype=torch.bfloat16)
    scattered = torch.empty(n // world, device="cuda", dtype=torch.bfloat16)
    out = {}
    for kind, call in (
            ("all-gather", lambda: dist.all_gather_into_tensor(gathered, x)),
            ("reduce-scatter",
             lambda: dist.reduce_scatter_tensor(scattered, x)),
            ("all-reduce", lambda: dist.all_reduce(x))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRANSPORT_REPS):
            call()
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TRANSPORT_REPS
        out[kind] = {"input_mib": TRANSPORT_MIB, "s": sec,
                     "gb_per_s_of_input": (TRANSPORT_MIB << 20) / sec / 1e9}
    del x, gathered, scattered
    torch.cuda.empty_cache()
    return out


def mesh_rank_run(torch, run):
    """Runs W, X and Y: the run's rank processes (``mesh_rank_main``,
    this script with ``--rank``) started together over a ``FileStore`` in
    a temporary directory, waited for (MESH_RANK_TIMEOUT_S; a failed or
    late rank fails the run, its output's tail printed), their lines
    read.  W is held to run P's first losses, X and Y to
    ``training.train`` of the same cut config and weights in this
    process, run after the ranks: the losses of the ranks equal, step 0
    within MESH_STEP0_REL relative and every step within TRAIN_LOSS_TOL of
    the baseline; each rank launches flash forward and backward as
    ``train_launches`` derives (all ``mma``) and nothing else of the port;
    the collectives each rank's plan counted at every step are the
    schedule's (``launch.dryrun.step_collectives``), kind for kind in
    bytes and calls.  Y's ranks run every RG-LRU recurrence on d_rnn / 2
    channels (the widths ``linear_scan`` saw) and gather no RG-LRU leaf
    over the model axis (each keeps its channel block).  Emits the
    ``train`` line (each rank's step times, peak and shard bytes, the
    transport, the counted collectives a step, their bytes over the whole
    step time, compute included, and in W each kind's rate alone; the
    baseline's beside them).  Returns the ranks' launch counts, summed."""
    import tempfile

    from repro_torch.training import train
    from repro_torch.weights import init_params

    cfg, tc, (data, model), reduced, n_steps = mesh_run_config(run)
    if cfg.moe is not None:
        check(cfg.moe_impl == "dispatch" and cfg.moe.capacity_factor == 1.0,
              f"run {run}: {cfg.name} is not the dispatch at capacity 1.0")
    world = data * model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", run,
             str(r), str(world), os.path.join(tmp, "store"), outs[r]],
            cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MESH_RANK_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-3000:])
            f.close()
        codes = [p.returncode for p in procs]
        check(codes == [0] * world, f"run {run}: rank processes exited "
              f"{codes} after {wall:.1f} s: {tails}")
        ranks = [json.loads(pathlib.Path(o).read_text()) for o in outs]
    loss = ranks[0]["losses"]
    if run == "W":
        base = {k: TRAIN_LINES["P"][k] for k in (
            "step_ms_median_after_first", "peak_mem_gib")}
        base["losses"] = TRAIN_LINES["P"]["losses"][:n_steps]
        base["run"] = "P"
    else:
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stamps = []
        t0 = time.perf_counter()
        with first_steps(n_steps):
            params, losses = train(
                cfg, tc, params=params, device="cuda",
                log=lambda msg: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        steps = np.diff([t0] + stamps) * 1e3
        base = {"run": "training.train, one process",
                "losses": [v for _, v in losses],
                "step_ms_median_after_first": float(np.median(steps[1:])),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    diffs = [abs(a - b) for a, b in zip(loss, base["losses"])]
    counted = ranks[0]["collectives_counted"]
    per_step = {k: {kind: v // n_steps for kind, v in counted[k].items()}
                for k in ("bytes", "counts")}
    want = {name: 0 for name in ranks[0]["launches"]}
    want.update(train_launches(cfg, n_steps))
    line = {"phase": "train", "run": run, "model": cfg.name,
            "entry": "training.train(mesh=...), two rank processes",
            "n_layers": cfg.n_layers, "fsdp": cfg.fsdp,
            "moe_impl": cfg.moe_impl if cfg.moe is not None else None,
            "batch": tc.batch, "seq_len": tc.seq_len, "steps": n_steps,
            "schedule_steps": tc.steps,
            "mesh": ranks[0]["mesh"], "transport": ranks[0]["backend"],
            "losses": loss, "baseline": base,
            "step0_rel_err": diffs[0] / abs(base["losses"][0]),
            "max_abs_loss_diff": max(diffs), "wall_s": wall,
            "collective_bytes_per_step": per_step["bytes"],
            "collective_counts_per_step": per_step["counts"],
            "collective_gb_per_s_over_whole_step": sum(
                per_step["bytes"].values()) / 1e9 / (
                    ranks[0]["step_ms_median_after_first"] / 1e3),
            "ranks": [{k: r[k] for k in (
                "rank", "step_ms", "step_ms_median_after_first",
                "shard_gib", "peak_mem_gib", "wall_s")} for r in ranks],
            "launches_per_rank": {k: v for k, v in ranks[0][
                "launches"].items() if v}}
    if "transport_rates" in ranks[0]:
        line["transport_rates_alone"] = ranks[0]["transport_rates"]
    if "channel_parallel" in ranks[0]:
        line["channel_parallel"] = [r["channel_parallel"] for r in ranks]
    if reduced:
        line["reduced"] = reduced
    emit(line)
    check(len(loss) == n_steps and all(np.isfinite(loss)),
          f"run {run}: losses {loss}")
    if not cfg.train_batch_over_model and model > 1:
        d_rnn = cfg.rglru.d_rnn or cfg.d_model
        for r in ranks:
            cp = r.get("channel_parallel", {})
            check(cp.get("linear_scan_widths") == [d_rnn // model]
                  and cp["rglru_leaves"] > 0
                  and cp["rglru_leaves_local"] == cp["rglru_leaves"]
                  and not cp["rglru_leaves_gathered_over_model"],
                  f"run {run}: rank {r['rank']}'s RG-LRU branch is not "
                  f"channel-parallel over {model} ranks: {cp}")
    check(all(r["losses"] == loss for r in ranks),
          f"run {run}: the ranks logged different losses")
    check(line["step0_rel_err"] <= MESH_STEP0_REL, f"run {run}: step 0's "
          f"loss {loss[0]} vs {base['losses'][0]}")
    check(max(diffs) <= TRAIN_LOSS_TOL, f"run {run}: losses {loss} vs "
          f"{base['losses']}")
    for r in ranks:
        sched = r["schedule_per_step"]
        by_step = r["collectives_counted_by_step"]
        check(len(by_step) == n_steps and all(c == sched for c in by_step),
              f"run {run}: rank {r['rank']} counted {by_step} a step, not "
              f"the schedule's {sched}")
        check(r["launches"] == want, f"run {run}: rank {r['rank']} "
              f"launched { {k: v for k, v in r['launches'].items() if v} }, "
              f"not { {k: v for k, v in want.items() if v} }")
    total = Counter()
    for r in ranks:
        total.update(r["launches"])
    return {name: total[name] for name in ranks[0]["launches"]}


def serve_mesh_config(run):
    """(cfg, reduced or None) of a Z run."""
    from repro_torch.configs import get_config

    arch, n_layers, fields, why = SERVE_MESH_RUNS[run]
    cfg = get_config(arch)
    reduced = None
    if n_layers is not None:
        full = cfg.n_params()
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        reduced = {"n_layers": [get_config(arch).n_layers, n_layers],
                   "n_params": [full, cfg.n_params()], "why": why}
    return dataclasses.replace(cfg, **fields), reduced


def serve_launches(cfg):
    """A rank's launches in one Z run, nothing else of the port: flash once
    per attention layer in the prefill (every prompt in one call: GQA,
    MLA, RecurrentGemma's local attention; an encoder-decoder's encoder
    layers and each decoder layer's cross-attention too), the SSD scan
    once per Mamba-2 layer; split-K once per decode step and GQA layer
    where the heads split, over its pools' dtype, and once per decode step
    and decoder layer for the cross-attention over the frames where its
    heads split (over a head-dim split decode runs a plain route; MLA
    decodes through ``torch.bmm``, Mamba-2 through its recurrence)."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2
    from repro_torch.models.sharding import cross_split, serve_layouts

    m = SERVE_MESH[1]
    kinds = cfg.layer_kinds()
    layouts = serve_layouts(cfg, m)
    n_gqa = sum(k in (ATTN, ATTN_LOCAL) for k in kinds)
    n_flash = n_gqa + sum(k == ATTN_MLA for k in kinds)
    n_ssd = sum(k == MAMBA2 for k in kinds)
    decode = Counter()
    if layouts.get(ATTN, layouts.get(ATTN_LOCAL)) == "heads":
        decode["int8" if cfg.kv_quant else "bf16"] += n_gqa * SERVE_STEPS
    if cfg.is_encoder_decoder:
        n_flash += cfg.n_encoder_layers + cfg.n_layers
        if cross_split(cfg, m) == "heads":
            decode["bf16"] += cfg.n_layers * SERVE_STEPS
    out = {}
    if n_flash:
        out.update({"flash_attention": n_flash,
                    "flash_attention:mma": n_flash})
    if n_ssd:
        out.update({"ssd_scan": n_ssd, "ssd_scan:mma": n_ssd})
    if decode:
        n = sum(decode.values())
        out.update({"paged_attention_splitk": n,
                    "paged_attention_splitk:mma": n,
                    **{f"paged_attention_splitk/{pools}": k
                       for pools, k in decode.items()}})
    return out


def serve_heads(cfg):
    """The (query heads, kv heads) each flash and paged launch of a Z
    run's rank sees, and the (heads, B/C groups) each SSD-scan launch
    sees, over every attention path of the stack: this rank's heads (GQA
    and an encoder's layers over heads; MLA, whose k carries every query
    head's rotary part; an encoder-decoder's cross-attention over heads),
    the kv heads its query heads attend (``"mixed"``: RecurrentGemma's
    local attention), every head (a head-dim split gathers whole heads
    for flash; its decode launches no kernel)."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2
    from repro_torch.models.sharding import cross_split, serve_layouts
    from repro_torch.models.ssm import mamba2_dims

    m = SERVE_MESH[1]
    layouts = serve_layouts(cfg, m)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    n = H // m
    heads = {"flash": set(), "paged": set(), "ssd": set()}
    for kind, layout in layouts.items():
        if kind == MAMBA2:
            heads["ssd"].add((mamba2_dims(cfg)[1] // m,
                              max(1, cfg.ssm.n_groups // m)))
        elif kind == ATTN_MLA:
            heads["flash"].add((n, n) if layout == "heads" else (H, H))
        elif kind in (ATTN, ATTN_LOCAL):
            if layout == "heads":
                heads["flash"].add((n, Hkv // m))
                heads["paged"].add((n, Hkv // m))
            elif layout == "mixed":
                heads["flash"].add((n, max(1, n // (H // Hkv))))
            else:
                heads["flash"].add((H, Hkv))
    if cfg.is_encoder_decoder:
        if cross_split(cfg, m) == "heads":
            heads["flash"].add((n, n))
            heads["paged"].add((n, n))
        else:
            heads["flash"].add((H, H))
    return {k: sorted(list(pair) for pair in v) for k, v in heads.items()}


def serve_mesh_inputs(run, cfg):
    """(prompt tokens (SERVE_PROMPTS, L), the prefill batch's stubbed
    frontend inputs, the caches' length) of a Z run, from SEED: prompts
    of SERVE_PROMPT_LEN drawn tokens into caches of SERVE_MAX_LEN; an
    encoder-decoder's WHISPER_SOT and drawn tokens,
    SERVE_WHISPER_PROMPT_LEN in all, over standard-normal ``frames``
    (n_frontend_tokens of them) into caches of MAX_LEN_WHISPER; a vision
    stack's standard-normal ``patch_embeds`` ahead of drawn tokens, the
    two SERVE_PROMPT_LEN positions in all."""
    rng = np.random.default_rng(SEED)
    B, P, d = SERVE_PROMPTS, cfg.n_frontend_tokens, cfg.d_model
    if cfg.is_encoder_decoder:
        prompts = np.concatenate([np.tile(WHISPER_SOT, (B, 1)), rng.integers(
            0, WHISPER_SOT[0], (B, SERVE_WHISPER_PROMPT_LEN
                                - len(WHISPER_SOT)))], axis=1)
        frames = rng.standard_normal((B, P, d)).astype(np.float32)
        return prompts, {"frames": frames}, MAX_LEN_WHISPER
    if cfg.frontend == "vision_stub":
        prompts = rng.integers(0, cfg.vocab_size, (B, SERVE_PROMPT_LEN - P))
        patches = rng.standard_normal((B, P, d)).astype(np.float32)
        return prompts, {"patch_embeds": patches}, SERVE_MAX_LEN
    return (rng.integers(0, cfg.vocab_size, (B, SERVE_PROMPT_LEN)), {},
            SERVE_MAX_LEN)


def serve_batch(torch, prompts, stub, rows=lambda t: t):
    """The prefill batch on the card: ``rows`` of the prompts and of the
    stubbed frontend inputs."""
    return {k: rows(torch.from_numpy(v).cuda())
            for k, v in dict(stub, tokens=prompts).items()}


def serve_baseline(torch, run, path):
    """One process's ``prefill`` and teacher-forced ``decode_step`` calls
    of run ``run`` (its own greedy tokens) on the weights from SEED and
    ``serve_mesh_inputs``; the prompts, the frames or patches, the caches'
    length, the tokens fed and every call's logits (f32) saved to
    ``path`` for the ranks and the checks.  Returns its times and peak."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.weights import init_params

    cfg, _ = serve_mesh_config(run)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    prompts, stub, max_len = serve_mesh_inputs(run, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(params, serve_batch(torch, prompts, stub), cfg,
                            max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    calls, fed, step_ms = [logits.float().cpu()], [], []
    for _ in range(SERVE_STEPS):
        fed.append(calls[-1].argmax(-1))
        t0 = time.perf_counter()
        logits, cache = decode_step(params, fed[-1].cuda(), cache, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(logits.float().cpu())
    np.savez(path, prompts=prompts, fed=torch.stack(fed).numpy(),
             logits=torch.stack(calls).numpy(), max_len=max_len, **stub)
    out = {"prefill_ms": prefill_ms,
           "decode_ms_median": float(np.median(step_ms)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_rank_main(argv) -> int:
    """One rank process of run Z (``--rank Z RANK WORLD STORE OUT``): joins
    the group over STORE (gloo, the ranks sharing the card), and for each
    Z run draws the whole tree from SEED, keeps its shards
    (``ServePlan.shard_params``; the rest freed), and under the plan
    prefills its rows of the prompts (and of the frames or patches) and
    decodes SERVE_STEPS steps teacher-forced with the one process's tokens
    (``serve_baseline``'s file beside OUT).  Writes each run's times, peaks, shard bytes,
    launches, the transport's time, the collectives counted per call
    beside ``serve_schedule``'s to OUT (JSON), and rank 0 every call's
    whole logits to ``OUT.<run>.npz``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import join_ranks, make_host_mesh
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.sharding import ServePlan, activate
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    *names, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    names = names[0].split(",") if names else list(SERVE_MESH_RUNS)
    backend = join_ranks(store, rank, world, "cuda")
    # the transport's wall time inside the timed calls: every collective
    # from the card's queue drained to the call's return
    transport = {"on": False, "s": 0.0}

    def clocked(call):
        def run(*args, **kw):
            if not transport["on"]:
                return call(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call(*args, **kw)
            torch.cuda.synchronize()
            transport["s"] += time.perf_counter() - t0
            return got
        return run

    dist.all_reduce = clocked(dist.all_reduce)
    dist.all_gather_into_tensor = clocked(dist.all_gather_into_tensor)
    # the (query heads, kv heads) each attention kernel launch of the
    # layers saw, the (heads, groups) each SSD-scan launch saw
    attn = importlib.import_module("repro_torch.models.attention")
    ssm = importlib.import_module("repro_torch.models.ssm")
    heads = {"flash": set(), "paged": set(), "ssd": set()}

    def spied(key, call, hq, hkv):
        def run(*args, **kw):
            heads[key].add((hq(args), hkv(args)))
            return call(*args, **kw)
        return run

    attn.flash_attention_kernel = spied(
        "flash", attn.flash_attention_kernel, lambda a: a[0].shape[2],
        lambda a: a[1].shape[2])
    attn.paged_attention = spied(
        "paged", attn.paged_attention, lambda a: a[0].shape[1],
        lambda a: a[1].shape[2])
    ssm.ssd_scan_kernel = spied(
        "ssd", ssm.ssd_scan_kernel, lambda a: a[0].shape[2],
        lambda a: a[2].shape[2])
    lines = {}
    try:
        mesh = make_host_mesh(model=SERVE_MESH[1])
        for run in names:
            cfg, _ = serve_mesh_config(run)
            with np.load(os.path.join(os.path.dirname(out),
                                      f"{run}.npz")) as f:
                prompts, fed = f["prompts"], f["fed"]
                stub = {k: f[k] for k in ("frames", "patch_embeds")
                        if k in f.files}
                max_len = int(f["max_len"])
            positions = prompts.shape[1] + sum(
                v.shape[1] for k, v in stub.items() if k == "patch_embeds")
            torch.cuda.reset_peak_memory_stats()
            params = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(SEED), "cuda")
            plan = ServePlan(mesh, cfg, SERVE_PROMPTS)
            plan.shard_params(params)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            draw_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            comm, calls, logits_all, step_ms, moved = plan.comm, [], [], [], []
            reset_launch_counts()
            for seen in heads.values():
                seen.clear()

            def call(fn, shape, cache_len):
                before = {"bytes": dict(comm.bytes),
                          "counts": dict(comm.counts)}
                transport.update(on=True, s=0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                transport["on"] = False
                moved.append(transport["s"] * 1e3 / ms)
                calls.append({
                    "counted": {k: {kind: getattr(comm, k)[kind]
                                    - before[k][kind] for kind in before[k]}
                                for k in ("bytes", "counts")},
                    "schedule": plan.serve_schedule(cfg, shape, cache_len)})
                return got, ms

            rows = plan.rows_of
            with activate(plan):
                (logits, cache), prefill_ms = call(lambda: prefill(
                    params, serve_batch(torch, prompts, stub, rows), cfg,
                    max_len), ShapeConfig("Z", positions, SERVE_PROMPTS,
                                          "prefill"), max_len)
                logits_all.append(plan.whole_logits(logits).float().cpu())
                for toks in fed:
                    (logits, cache), ms = call(lambda: decode_step(
                        params, rows(torch.from_numpy(toks).cuda()), cache,
                        cfg), ShapeConfig("Z", 1, SERVE_PROMPTS, "decode"),
                        max_len)
                    step_ms.append(ms)
                    logits_all.append(plan.whole_logits(logits)
                                      .float().cpu())
            launches = launch_counts()
            if rank == 0:
                np.savez(f"{out}.{run}.npz",
                         logits=torch.stack(logits_all).numpy())
            lines[run] = {
                "rank": rank, "backend": backend, "layout": plan.layout,
                "layouts": plan.layouts, "cross_layout": plan.cross_layout,
                "prompt_len": prompts.shape[1], "positions": positions,
                "max_len": max_len,
                "mesh": {"shape": list(mesh.shape),
                         "axes": list(mesh.mesh_dim_names)},
                "prefill_ms": prefill_ms,
                "decode_ms_median": float(np.median(step_ms)),
                "transport_share_prefill": moved[0],
                "transport_share_decode_median": float(np.median(
                    moved[1:])),
                "shard_gib": sum(t.numel() * t.element_size()
                                 for t in _leaves(params)) / 2 ** 30,
                "cache_gib": sum(t.numel() * t.element_size()
                                 for t in _leaves(cache)) / 2 ** 30,
                "draw_peak_gib": draw_peak,
                "serve_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": launches, "calls": calls,
                "heads": {k: sorted(v) for k, v in heads.items()}}
            del params, cache, logits, plan
            gc.collect()
            torch.cuda.empty_cache()
        with open(out, "w") as f:
            json.dump(lines, f)
    finally:
        dist.destroy_process_group()
    return 0


def greedy_flips(want, got):
    """The positions where the mesh's greedy token differs from one
    process's, over (calls, rows, vocab) logits: ([call, row, the one
    process's margin of its argmax over the runner-up, the mesh's of its
    own, both over the call's largest |logit|], how many of them are bf16
    ties: the mesh's token within one bf16 step (of the row's largest
    logit) of the one process's largest logit, which that process's bf16
    logits cannot tell apart from its argmax)."""
    flips, tied = [], 0
    for c, r in zip(*np.nonzero(got.argmax(-1) != want.argmax(-1))):
        scale = np.abs(want[c]).max()
        w2, g2 = (np.sort(a[c, r])[-2:] for a in (want, got))
        flips.append([int(c), int(r), float((w2[1] - w2[0]) / scale),
                      float((g2[1] - g2[0]) / scale)])
        step = 2.0 ** (np.floor(np.log2(np.abs(w2[1]))) - 7)
        tied += bool(want[c, r, got[c, r].argmax()] >= w2[1] - step)
    return flips, tied


def serve_mesh_run(torch, names=tuple(SERVE_MESH_RUNS)):
    """Run Z (the runs ``names``, all by default): for each one process's
    baseline first (``serve_baseline``), then two rank processes
    (``serve_rank_main``, this script with ``--rank Z:<names>``) over a
    (1, 2) mesh on the card, started
    together over a ``FileStore`` and waited for (MESH_RANK_TIMEOUT_S, as
    W-Y).  Holds every call's logits (rank 0's, gathered whole) within
    DENSE_REL_TOL of the largest baseline logit and the greedy agreement,
    bf16 ties of the one process's logits counted as agreement
    (``greedy_flips``), at SERVE_GREEDY_MIN or above; each rank's launches equal
    ``serve_launches`` (flash, split-K and the SSD scan on its heads,
    ``serve_heads``) and nothing else of the port; each call's counted collectives equal
    ``ServePlan.serve_schedule``.  Emits a ``serve_mesh`` line per run
    (each rank's prefill and decode ms, the transport's share of each,
    shard, cache and peak bytes; the baseline's times and peak beside).
    Returns the ranks' launch counts, summed."""
    import tempfile

    world = SERVE_MESH[0] * SERVE_MESH[1]
    total = Counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        base = {run: serve_baseline(torch, run, os.path.join(tmp,
                                                              f"{run}.npz"))
                for run in names}
        out = os.path.join(tmp, "ranks.json")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank",
             ":".join(("Z", ",".join(names))), str(r), str(world),
             os.path.join(tmp, "store"),
             f"{out}.rank{r}"], cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MESH_RANK_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-3000:])
            f.close()
        codes = [p.returncode for p in procs]
        check(codes == [0] * world, f"run Z: rank processes exited {codes} "
              f"after {wall:.1f} s: {tails}")
        ranks = [json.loads(pathlib.Path(f"{out}.rank{r}").read_text())
                 for r in range(world)]
        for run in names:
            cfg, reduced = serve_mesh_config(run)
            with np.load(os.path.join(tmp, f"{run}.npz")) as f:
                want = f["logits"]
            with np.load(f"{out}.rank0.{run}.npz") as f:
                got = f["logits"]
            rel = [float(np.abs(g - w).max() / np.abs(w).max())
                   for g, w in zip(got, want)]
            agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
            flips, tied = greedy_flips(want, got)
            beyond_ties = 1.0 - (len(flips) - tied) / got.shape[0] \
                / got.shape[1]
            lines = [r[run] for r in ranks]
            expect = {name: 0 for name in lines[0]["launches"]}
            expect.update(serve_launches(cfg))
            line = {"phase": "serve_mesh", "run": run, "model": cfg.name,
                    "entry": "models.prefill / decode_step under "
                             "sharding.ServePlan, two rank processes",
                    "n_layers": cfg.n_layers, "kv_quant": cfg.kv_quant,
                    "moe_impl": cfg.moe_impl if cfg.moe else None,
                    "layout": lines[0]["layout"],
                    "layouts": lines[0]["layouts"],
                    "cross_layout": lines[0]["cross_layout"],
                    "mesh": lines[0]["mesh"],
                    "transport": lines[0]["backend"],
                    "prompts": SERVE_PROMPTS,
                    **{k: lines[0][k] for k in ("prompt_len", "positions",
                                                "max_len")},
                    "decode_steps": SERVE_STEPS,
                    "logit_rel_err_by_call": rel,
                    "max_logit_rel_err": max(rel),
                    "greedy_agreement": agree,
                    "greedy_agreement_beyond_ties": beyond_ties,
                    "greedy_flips": flips,
                    "baseline": dict(base[run], run="one process"),
                    "collective_bytes_prefill": lines[0]["calls"][0][
                        "counted"]["bytes"],
                    "collective_bytes_decode_step": lines[0]["calls"][1][
                        "counted"]["bytes"],
                    "ranks": [{k: r[k] for k in (
                        "rank", "prefill_ms", "decode_ms_median",
                        "transport_share_prefill",
                        "transport_share_decode_median", "shard_gib",
                        "cache_gib", "draw_peak_gib", "serve_peak_gib")}
                        for r in lines],
                    "launches_per_rank": {k: v for k, v in lines[0][
                        "launches"].items() if v},
                    "heads_per_launch": lines[0]["heads"],
                    "ranks_wall_s": wall}
            if reduced:
                line["reduced"] = reduced
            emit(line)
            check(np.isfinite(got).all() and got.shape == want.shape,
                  f"run {run}: logits {got.shape} against {want.shape}")
            check(max(rel) <= DENSE_REL_TOL, f"run {run}: logits off the "
                  f"one process's by {max(rel)} of the largest")
            check(beyond_ties >= SERVE_GREEDY_MIN, f"run {run}: greedy "
                  f"agreement beyond bf16 ties {beyond_ties} with one "
                  f"process, under {SERVE_GREEDY_MIN}: {flips}")
            local = serve_heads(cfg)
            for r in lines:
                check(r["heads"] == local,
                      f"run {run}: rank {r['rank']}'s kernels saw heads "
                      f"{r['heads']}, not this rank's {local}")
                check(r["launches"] == expect, f"run {run}: rank "
                      f"{r['rank']} launched "
                      f"{ {k: v for k, v in r['launches'].items() if v} }, "
                      f"not { {k: v for k, v in expect.items() if v} }")
                check(all(c["counted"] == c["schedule"] for c in r["calls"]),
                      f"run {run}: rank {r['rank']} counted collectives "
                      f"other than the schedule's: {r['calls'][:2]}")
                total.update(r["launches"])
    return {name: total[name] for name in launch_counts()}


def ring_bwd_ratio(torch, got, want, tol):
    """(max |got - want|, that over ``tol``)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / tol


def ring_phase(torch):
    """Ring flash attention (``models.ring_attention``) at RING_CASES'
    full-width bf16 shapes, forward and backward at a fixed output
    gradient drawn from SEED:

    - forward: ``ring_attention_sharded`` on the host mesh (n = 1: one
      flash call and an NCCL all-gather), bit for bit one flash call over
      the whole sequence; the ring's steps and merge over RING_SHARDS
      sequence shards in one process (``ring_attention_shards``: every
      rank's flash calls with ``lse``, causal on the diagonal, full below
      it, later shards skipped), within ``ring_tolerance`` (3 x 2**-8 max
      |v|) of one flash call and of the f32 plain ring;
    - backward (``RingFlashAttentionFunction`` at n = 1 through the mesh:
      dq, dk, dv bit for bit one ``flash_attention_bwd_kernel`` call; the
      8 shards' backward, each step a backward call in the accumulate
      mode, within ``ring_bwd_tolerance`` of one backward call given the
      ring's output and L, and a planted fault, one step's dK/dV dropped
      or the diagonal step's lse for L, outside it);
    - the accumulate mode added into zeros and rounded once: the default
      bf16 output bit for bit;
    - at S = 4096 on Granite's heads, where the f32 plain ring's saved
      scores fit: the f32 ring's gradient (the ``fma`` kernels) within
      BWD_F32_REL of ``torch.autograd`` of ``ring_attention_plain``, and
      the bf16 ring's distance from it (reported), and the f32 accumulate
      mode from zeros bit for bit the default.

    The ring paths' flash launches are counted (forward 1 + n(n+1)/2
    causal, 1 + n**2 full; the backward runs the forward again and a
    backward call per step not skipped, each three kernel launches, all
    in the accumulate mode) and the comparisons' are not; the ring's ms
    (8 shards in one process, n = 1 through the mesh) beside one call's
    and the bound, forward and backward.  Returns (the launch counts, the
    forward rows and the backward rows for the ``kernels`` line)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ra = importlib.import_module("repro_torch.models.ring_attention")
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    n = RING_SHARDS
    total, rows, bwd_rows = Counter(), {}, {}
    for ci, (name, S, Hq, Hkv, D, causal) in enumerate(RING_CASES):
        g = torch.Generator(device="cuda").manual_seed(SEED + 700 + ci)
        q, k, v = (torch.randn(1, S, h, D, generator=g, device="cuda").to(
            torch.bfloat16) for h in (Hq, Hkv, Hkv))
        do = torch.randn(1, S, Hq, D, generator=g, device="cuda").to(
            torch.bfloat16)
        reset_launch_counts()
        one = ra.ring_attention_sharded(q, k, v, mesh, causal=causal)
        ring = ra.ring_attention_shards(q, k, v, n, causal=causal)
        torch.cuda.synchronize()
        counts = launch_counts()
        total.update(counts)
        steps = n * (n + 1) // 2 if causal else n * n
        want = 1 + steps
        single, lse = fa.flash_attention_kernel(q, k, v, causal=causal,
                                                return_lse=True)
        plain = ra.ring_attention_plain(q, k, v, n, causal=causal)
        tol = ra.ring_tolerance(v, torch.bfloat16)
        err_single = float((ring.float() - single.float()).abs().max())
        err_plain = float((ring.float() - plain).abs().max())
        del plain
        bound, bound_by = flash_bound(S, S, Hq, Hkv, D, causal, 0,
                                      "bfloat16")
        line = {"phase": "kernels", "kernel": "ring_attention", "case": name,
                "dtype": "bfloat16", "B": 1, "S": S, "Hq": Hq, "Hkv": Hkv,
                "D": D, "causal": causal, "shards": n,
                "flash_launches": counts["flash_attention"],
                "flash_launches_mma": counts["flash_attention:mma"],
                "n1_bitwise_equal_single_call": bool(torch.equal(one,
                                                                 single)),
                "tol": tol, "max_abs_err_vs_single": err_single,
                "max_abs_err_vs_plain_f32": err_plain,
                "tol_ratio": max(err_single, err_plain) / tol,
                "ms": time_ms(torch, lambda: ra.ring_attention_shards(
                    q, k, v, n, causal=causal), 5, flush),
                "n1_mesh_ms": time_ms(
                    torch, lambda: ra.ring_attention_sharded(
                        q, k, v, mesh, causal=causal), 5, flush),
                "single_call_ms": time_ms(
                    torch, lambda: fa.flash_attention_kernel(
                        q, k, v, causal=causal), 10, flush),
                "bound_ms": bound, "bound_by": bound_by}
        emit(line)
        check(counts["flash_attention"] == want == counts[
            "flash_attention:mma"] and sum(counts.values()) == 2 * want,
              f"ring {name}: launches {counts}, not {want} flash:mma")
        check(line["n1_bitwise_equal_single_call"], f"ring {name}: n = 1 "
              "through the mesh is not one flash call bit for bit")
        check(line["tol_ratio"] <= 1 and bool(torch.isfinite(
            ring.float()).all()), f"ring {name}: {err_single} from the "
              f"single call, {err_plain} from the plain ring, tol {tol}")
        rows[name] = {k: line[k] for k in (
            "flash_launches", "ms", "n1_mesh_ms", "single_call_ms",
            "bound_ms", "bound_by", "tol_ratio")}
        del one, ring
        torch.cuda.empty_cache()
        bwd_rows[name] = ring_bwd_case(torch, fa, ra, mesh, flush, total,
                                       name, q, k, v, do, single, lse,
                                       causal, steps)
        del q, k, v, do, single, lse
        torch.cuda.empty_cache()
        if name.startswith("granite"):
            bwd_rows[name].update(ring_bwd_plain_case(
                torch, fa, ra, SEED + 710 + ci, Hq, Hkv, D, causal))
    return dict(total), rows, bwd_rows


def ring_bwd_case(torch, fa, ra, mesh, flush, total, name, q, k, v, do,
                  single, lse, causal, steps):
    """The ring's backward at one RING_CASES shape (``ring_phase``):
    emits its line, adds the ring paths' launches to ``total`` and
    returns its row."""
    n = RING_SHARDS

    def grads(fn):
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = fn(qg, kg, vg)
        return out, (qg, kg, vg), torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True)

    reset_launch_counts()
    out1, in1, g1 = grads(lambda a, b, c: ra.ring_attention_sharded(
        a, b, c, mesh, causal=causal))
    out8, in8, g8 = grads(lambda a, b, c: ra.ring_attention_shards(
        a, b, c, n, causal=causal))
    torch.cuda.synchronize()
    counts = launch_counts()
    total.update(counts)
    calls = 1 + steps
    check(counts["flash_attention_bwd"] == calls == counts[
        "flash_attention_bwd:mma"] == counts["flash_attention_bwd:acc"]
        and counts["flash_attention"] == calls,
          f"ring backward {name}: launches "
          f"{ {k: c for k, c in counts.items() if c} }, not {calls} "
          "backward calls (all mma, accumulate) and forward calls")
    # n = 1: one backward call over the whole sequence, bit for bit
    one = fa.flash_attention_bwd_kernel(q, k, v, single, lse, do,
                                        causal=causal)
    n1_equal = all(bool(torch.equal(a, b)) for a, b in zip(g1, one))
    # the accumulate mode into zeros, rounded once: the default's bits
    acc = tuple(torch.zeros(t.shape, device="cuda") for t in (q, k, v))
    fa.flash_attention_bwd_kernel(q, k, v, single, lse, do, causal=causal,
                                  accumulate=acc)
    acc_equal = all(bool(torch.equal(a.to(torch.bfloat16), b))
                    for a, b in zip(acc, one))
    del acc
    # 8 shards: one backward call given the ring's output and L
    out_r, big_l = ra.ring_attention_shards(q, k, v, n, causal=causal,
                                            return_lse=True)
    want = fa.flash_attention_bwd_kernel(q, k, v, out_r, big_l, do,
                                         causal=causal)
    errs = {}
    for gname, got, w in zip(("dq", "dk", "dv"), g8, want):
        errs[gname] = ring_bwd_ratio(torch, got, w, ra.ring_bwd_tolerance(
            w, torch.bfloat16))
    # the planted faults: each must fall outside the tolerance
    tol_k = ra.ring_bwd_tolerance(want[1], torch.bfloat16)
    step_bwd, merge = ra.ring_step_bwd, ra.ring_merge

    def drop_one(q_, k_t, v_t, o, l_, d_, idx, src, acc, causal=True):
        if (idx, src) == (n - 1, 1):       # a step every mask keeps
            acc = (acc[0], torch.zeros_like(acc[1]),
                   torch.zeros_like(acc[2]))
        return step_bwd(q_, k_t, v_t, o, l_, d_, idx, src, acc,
                        causal=causal)

    def partial_lse(parts, dtype):
        return merge(parts, dtype)[0], parts[0][1]

    faults = {}
    for fault, attr, fn in (("one_step_dk_dropped", "ring_step_bwd",
                             drop_one),
                            ("partial_lse_for_L", "ring_merge",
                             partial_lse)):
        setattr(ra, attr, fn)
        try:
            bad = grads(lambda a, b, c: ra.ring_attention_shards(
                a, b, c, n, causal=causal))[2][1]
        finally:
            ra.ring_step_bwd, ra.ring_merge = step_bwd, merge
        faults[fault] = float((bad.float() - want[1].float()).abs().max()) \
            / tol_k
        del bad
    bound, bound_by = flash_bwd_bound(q.shape[1], q.shape[1], q.shape[2],
                                      k.shape[2], q.shape[3], v.shape[3],
                                      causal, 0, "bfloat16")
    line = {"phase": "kernels", "kernel": "ring_attention_bwd",
            "case": name, "dtype": "bfloat16", "S": q.shape[1],
            "shards": n, "backward_calls": counts["flash_attention_bwd"],
            "backward_kernel_launches": 3 * counts["flash_attention_bwd"],
            "backward_calls_accumulate": counts["flash_attention_bwd:acc"],
            "forward_calls": counts["flash_attention"],
            "n1_bitwise_equal_one_call": n1_equal,
            "accumulate_from_zeros_bitwise_equal_default": acc_equal,
            "tolerance": "one bf16 step of the largest |grad| "
                         "(ring_bwd_tolerance)",
            "max_abs_err_vs_one_call": {k: e for k, (e, _) in errs.items()},
            "tol_ratio": max(r for _, r in errs.values()),
            "planted_fault_tol_ratio": faults,
            "ms": time_ms(torch, lambda: torch.autograd.grad(
                out8, in8, do, retain_graph=True), 5, flush),
            "n1_mesh_ms": time_ms(torch, lambda: torch.autograd.grad(
                out1, in1, do, retain_graph=True), 5, flush),
            "one_call_ms": time_ms(torch, lambda: fa.flash_attention_bwd_kernel(
                q, k, v, single, lse, do, causal=causal), 5, flush),
            "bound_ms": bound, "bound_by": bound_by}
    emit(line)
    check(n1_equal, f"ring backward {name}: n = 1 through the mesh is not "
          "one backward call bit for bit")
    check(acc_equal, f"ring backward {name}: the accumulate mode from "
          "zeros is not the bf16 output bit for bit")
    check(line["tol_ratio"] <= 1 and all(
        bool(torch.isfinite(t.float()).all()) for t in g8),
          f"ring backward {name}: {line['max_abs_err_vs_one_call']} from "
          f"one backward call (ratio {line['tol_ratio']})")
    check(all(r > 1 for r in faults.values()), f"ring backward {name}: a "
          f"planted fault fell inside the tolerance: {faults}")
    del out1, out8, in1, in8, g1, g8, one, want, out_r, big_l
    return {k: line[k] for k in (
        "backward_calls", "backward_kernel_launches", "ms", "n1_mesh_ms",
        "one_call_ms", "bound_ms", "bound_by", "tol_ratio",
        "planted_fault_tol_ratio")}


def ring_bwd_plain_case(torch, fa, ra, seed, Hq, Hkv, D, causal, S=4096):
    """At S = 4096 on ``Hq``/``Hkv`` heads of ``D``: the f32 ring's
    gradient over RING_SHARDS shards (the ``fma`` kernels) against
    ``torch.autograd`` of ``ring_attention_plain`` within BWD_F32_REL of
    the largest |plain| (held), the bf16 ring's distance from it
    (reported), and the f32 accumulate mode from zeros bit for bit the
    default f32 output.  Launches here are comparisons: not counted."""
    n = RING_SHARDS
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(1, S, h, D, generator=g, device="cuda")
                   for h in (Hq, Hkv, Hkv, Hq))

    def grads(fn, dt):
        ins = tuple(t.detach().to(dt).requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(fn(*ins), ins, do.to(dt))

    plain = grads(lambda a, b, c: ra.ring_attention_plain(
        a, b, c, n, causal=causal), torch.float32)
    f32 = grads(lambda a, b, c: ra.ring_attention_shards(
        a, b, c, n, causal=causal), torch.float32)
    bf16 = grads(lambda a, b, c: ra.ring_attention_shards(
        a, b, c, n, causal=causal), torch.bfloat16)
    out = {"S4096_f32_vs_plain_rel": {}, "S4096_bf16_vs_plain_rel": {}}
    for gname, p, a, b in zip(("dq", "dk", "dv"), plain, f32, bf16):
        top = float(p.abs().max())
        out["S4096_f32_vs_plain_rel"][gname] = float(
            (a - p).abs().max()) / top
        out["S4096_bf16_vs_plain_rel"][gname] = float(
            (b.float() - p).abs().max()) / top
    o, lse = fa.flash_attention_kernel(q, k, v, causal=causal,
                                       return_lse=True)
    default = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                            causal=causal)
    acc = tuple(torch.zeros_like(t) for t in (q, k, v))
    fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal,
                                  accumulate=acc)
    out["S4096_f32_accumulate_from_zeros_bitwise_equal_default"] = all(
        bool(torch.equal(a, b)) for a, b in zip(acc, default))
    emit({"phase": "kernels", "kernel": "ring_attention_bwd",
          "case": f"S4096_h{Hq}_kv{Hkv}_d{D}_"
                  f"{'causal' if causal else 'full'}",
          "tolerance_f32": f"{BWD_F32_REL} x the largest |plain|", **out})
    check(max(out["S4096_f32_vs_plain_rel"].values()) <= BWD_F32_REL,
          f"ring backward f32 at S 4096: {out['S4096_f32_vs_plain_rel']} "
          "of the largest |plain|")
    check(out["S4096_f32_accumulate_from_zeros_bitwise_equal_default"],
          "flash backward f32: the accumulate mode from zeros is not the "
          "default output bit for bit")
    del plain, f32, bf16, default, acc
    torch.cuda.empty_cache()
    return out


def dryrun_phase(torch):
    """The dry-run CLI (``python -m repro_torch.launch.dryrun`` with
    DRYRUN_ARGS) in a subprocess that sees no card: its fake process
    group of 256 ranks lives there, never beside this process's; a
    nonzero exit fails the run.  Prints one device's argument and output
    bytes, FLOPs and collective bytes and counts by kind (the port's
    schedules: training's and, for decode_32k, serving's) from its result
    files.  Then
    ``launch.train --production`` on this one card must refuse with the
    world-size message, not train."""
    from repro_torch.launch import train as launch_train

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *DRYRUN_ARGS], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"dry-run exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    out_dir = ROOT / "experiments" / "dryrun_torch"
    meshes = {}
    for shape in DRYRUN_SHAPES:
        for kind in DRYRUN_MESHES:
            res = json.loads((out_dir / f"llama2-7b__{shape}__{kind}.json")
                             .read_text())
            check(res["collectives"] is not None, f"dry-run {shape} "
                  f"{kind}: no collectives: {res.get('collectives_reason')}")
            meshes[f"{shape}/{kind}"] = {"devices": res["devices"], **{
                k: res["memory"][k] for k in ("argument_bytes",
                                              "output_bytes")},
                "flops_per_device": res["cost"]["flops"],
                "flops_global": res["cost"]["flops_global"],
                "collective_bytes": res["collectives"]["bytes"],
                "collective_counts": res["collectives"]["counts"],
                "step_s": res["step_s"]}
    emit({"phase": "dryrun", "args": list(DRYRUN_ARGS), "wall_s": wall,
          "meshes": meshes})
    try:
        launch_train.main(["--arch", "granite-3-2b", "--production",
                           "--steps", "1"])
    except RuntimeError as e:
        refused = str(e)
    else:
        fail("--production on one card did not refuse")
    emit({"phase": "production", "refused": refused})
    check("needs a process group of 256 ranks" in refused
          and "found world size 1" in refused,
          f"--production refused without the world-size message: {refused}")


def whisper_run(torch):
    """Run N: Whisper large-v3 as registered (32 encoder and 32 decoder
    layers, d_model 1280, 20 heads of 64, GELU MLP of 5120, vocab 51 866,
    untied, bf16; random weights from SEED) through the model API, which
    is how an encoder-decoder is served (the engine's requests carry no
    frames).  Two prefill calls of 4 requests each over (4, 1500, 1280)
    standard-normal frames, one with the 4-token start-of-transcript
    prompt and one with a 64-token prompt, each launching flash once per
    encoder layer, decoder self-attention and cross-attention (96); then
    the 8 requests decode together (rows at two positions) greedily to
    WHISPER_NEW_TOKENS new tokens each, each step launching split-K once
    per decoder self- and cross-attention (64): the slot caches of
    MAX_LEN_WHISPER slots as pages of 16, the 1500 frames as pages of 4.
    Checks: the launch counts of each phase and nothing else of the
    port, finite logits, the first tokens of a short and a long prompt
    against ``whisper_plain`` on the card, decode consistency at 444
    tokens (max_len 448); the decode and prefill profile windows.
    Returns the launch counts of the three phases, summed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.weights import init_params

    cfg = get_config("whisper-large-v3")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "engine_setup", "run": "N", "model": cfg.name,
          "n_layers": cfg.n_layers, "n_encoder_layers": cfg.n_encoder_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "n_params": cfg.n_params(), "weight_gib": sum(
              t.numel() * t.element_size() for t in _leaves(params)) / 2 ** 30,
          "init_s": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED + 19)
    T, d = cfg.n_frontend_tokens, cfg.d_model
    batches = []
    for plen in (len(WHISPER_SOT), 64):
        toks = np.concatenate([np.tile(WHISPER_SOT, (4, 1)), rng.integers(
            0, WHISPER_SOT[0], (4, plen - len(WHISPER_SOT)))], axis=1)
        frames = rng.standard_normal((4, T, d)).astype(np.float32)
        batches.append({"tokens": torch.from_numpy(toks).to("cuda"),
                        "frames": torch.from_numpy(frames).to("cuda")})
    # flash once per encoder layer and per decoder layer's self- and
    # cross-attention (32 + 2 x 32 = 96 a call); split-K once per decoder
    # layer's self- and cross-attention (64 a step)
    others = {name: 0 for name in launch_counts()}
    n_flash = cfg.n_encoder_layers + 2 * cfg.n_layers
    flash = dict(others, **{"flash_attention": n_flash,
                            "flash_attention:mma": n_flash})
    n_steps = WHISPER_NEW_TOKENS - 1
    splitk = dict(others, **{k: 2 * cfg.n_layers * n_steps for k in (
        "paged_attention_splitk", "paged_attention_splitk:mma",
        "paged_attention_splitk/bf16")})

    def phase(name, want, fn):
        """fn() between a reset and a read of the launch counts, which
        must equal ``want``; (fn's result, wall seconds, the counts)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        check(got == want, f"run N, {name}: launches "
              f"{ {k: n for k, n in got.items() if n} }, not "
              f"{ {k: n for k, n in want.items() if n} }")
        return out, wall, got

    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    runs, walls, firsts, caches = [], [], [], []
    for i, b in enumerate(batches):
        (logits, cache), wall, got = phase(
            f"prefill call {i}", flash,
            lambda: prefill(params, b, cfg, MAX_LEN_WHISPER))
        check(bool(torch.isfinite(logits.float()).all()),
              f"run N: prefill call {i}: non-finite logits")
        runs.append(got)
        walls.append(wall)
        firsts.append(logits.float().cpu().numpy())
        caches.append(cache)
    # the 8 requests in one decode batch: rows at positions 4 and 64
    cache = {"pos": torch.cat([c["pos"] for c in caches]), "stages": {
        si: {name: torch.cat([c["stages"][si][name] for c in caches], dim=1)
             for name in st} for si, st in caches[0]["stages"].items()}}
    del caches
    first = torch.from_numpy(np.concatenate(firsts)).to("cuda").argmax(-1)

    def decode():
        tok, finite, out = first, torch.ones((), dtype=torch.bool,
                                             device="cuda"), [first]
        for _ in range(n_steps):
            logits, _ = decode_step(params, tok, cache, cfg)
            finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1)
            out.append(tok)
        return finite, torch.stack(out, 1)

    (finite, tokens), decode_s, got = phase("decode", splitk, decode)
    runs.append(got)
    check(bool(finite), "run N: non-finite decode logits")
    check(tokens.shape == (8, WHISPER_NEW_TOKENS), f"run N: tokens "
          f"{tuple(tokens.shape)}")
    prompt_tokens = sum(int(b["tokens"].numel()) for b in batches)
    emit({"phase": "engine", "run": "N", "model": cfg.name,
          "entry": "models.prefill / models.decode_step",
          "max_len": MAX_LEN_WHISPER, "requests": 8, "prefill_calls": 2,
          "frames_per_request": T, "prompt_tokens": prompt_tokens,
          "output_tokens": int(tokens.numel()), "decode_steps": n_steps,
          "prefill_call_ms": [w * 1e3 for w in walls],
          "decode_ms_per_step": decode_s / n_steps * 1e3,
          "output_tok_per_s_decode": 8 * n_steps / decode_s,
          "launches_by_phase": [{k: n for k, n in r.items() if n}
                                for r in runs],
          "distinct_tokens_per_request": [
              len(set(r)) for r in tokens.cpu().tolist()],
          "start_mem_gib": start_gib,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

    # first tokens of a short and a long prompt against a plain forward
    worst = 0.0
    with torch.no_grad():
        for ci, b in enumerate(batches):
            ref = whisper_plain(torch, params, cfg, b["frames"][0],
                                b["tokens"][0]).cpu().numpy()
            served = firsts[ci][0]
            rel = float(np.abs(served - ref).max() / np.abs(ref).max())
            worst = max(worst, rel)
            emit({"phase": "dense_check", "model": cfg.name, "run": "N",
                  "prefill_call": ci, "prompt_len": int(b["tokens"].shape[1]),
                  "frames": T, "max_rel_err": rel, "argmax_equal":
                      int(np.argmax(served)) == int(np.argmax(ref))})
    check(worst < DENSE_REL_TOL, f"run N: served first-token logits differ "
          f"from the plain forward by {worst} (relative)")
    decode_consistency(torch, params, cfg, n=MAX_LEN_WHISPER - 4)

    # profile windows: 10 decode steps of the 8 rows after 10 timed on
    # the host clock, and one prefill call (the 64-token prompts)
    tok = tokens[:, -1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        logits, _ = decode_step(params, tok, cache, cfg)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            logits, _ = decode_step(params, tok, cache, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    emit({"phase": "profile", "run": "N", "window": "decode",
          "iterations": 10, "rows_per_iteration": 8,
          **profile_summary(prof, 10, wall_ms)})
    del cache
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, batches[1], cfg, MAX_LEN_WHISPER)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", "run": "N", "window": "prefill",
          "iterations": 1, "rows_per_iteration": 4,
          "prompt_rows_per_iteration": [int(batches[1]["tokens"].numel())],
          "frames_per_iteration": 4 * T,
          **profile_summary(prof, 1, wall_ms)})
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def no_casts(run, line, paged=True):
    """A slots decode window reads its caches in their dtype: the paged
    kernels run in it (``paged``; MLA's latent decode runs none), and a
    decode step's extra device memory stays below an f32 copy of one
    layer's slot caches (the f32 casts that the plain products made,
    layer after layer)."""
    ours = " ".join(line["port_kernels_ms_per_iteration"])
    check(not paged or "paged_attention_mma_kernel" in ours, f"run {run}: "
          f"the decode window launched no paged kernel: {ours}")
    check(line["decode_step_extra_peak_bytes"]
          < line["layer_cache_f32_copy_bytes"], f"run {run}: a decode step "
          f"took {line['decode_step_extra_peak_bytes']} B beyond its "
          f"caches, not below an f32 copy of one layer's "
          f"({line['layer_cache_f32_copy_bytes']} B)")


def prefix_cache_run(torch, model, expect):
    """Run I: multi-turn conversations sharing system prompts (the
    port's ``multiturn_sharegpt_like``: 3 clients, 2 conversations of 2-4
    turns each, a pool of 2 system prompts of 64 tokens; prompts held to
    448 tokens so they fit max_len 512, outputs cut to 32 tokens so the
    run stays short), served cold and with the prefix cache on model's
    weights.  Warm first-token logits against cold ones: asserted within
    DENSE_REL_TOL of the largest logit (a warm prompt prefills only its
    uncached suffix, in other chunks beside other rows, so its products
    may take other cuBLAS algorithms); bitwise equality and greedy-token
    agreement are reported.  Returns the two runs' launch counts."""
    from repro_torch.workloads import multiturn_sharegpt_like

    def trace():
        reqs = multiturn_sharegpt_like(
            n_clients=3, n_conversations=2, turns=(2, 5), system_pool=2,
            system_len=64, think_time=2.0, max_prompt=448, seed=SEED)
        for r in reqs:
            r.output_len = min(r.output_len, 32)
        return reqs

    out = {}
    for cache in (False, True):
        tokens, firsts, launches, line = serve(
            torch, "I", model, 512, False, expect, reqs=trace(),
            backend="paged", prefix_cache=cache)
        out[cache] = tokens, firsts, launches, line
    st = out[True][3]["prefix_cache"]
    check(st["hits"] > 0 and st["hit_tokens"] > 0,
          f"run I: no prefix-cache hits: {st}")
    worst, bitwise, argmax = 0.0, 0, 0
    (cold_tok, cold_first), (warm_tok, warm_first) = (
        out[c][:2] for c in (False, True))
    for rid, (toks, cold) in cold_first.items():
        warm = warm_first[rid][1]
        rel = float(np.abs(warm - cold).max() / np.abs(cold).max())
        worst = max(worst, rel)
        bitwise += int(np.array_equal(warm, cold))
        argmax += int(np.argmax(warm) == np.argmax(cold))
    agree = np.mean([warm_tok[rid] == cold_tok[rid] for rid in cold_tok])
    emit({"phase": "prefix_cache_check", "run": "I", "requests":
          len(cold_first), "hits": st["hits"],
          "hit_tokens": st["hit_tokens"], "hit_rate": st["hit_rate"],
          "warm_vs_cold_max_rel_err": worst, "first_rows_bitwise_equal":
          bitwise, "first_argmax_equal": argmax,
          "greedy_token_agreement": float(agree)})
    check(worst < DENSE_REL_TOL, f"run I: warm first-token logits differ "
          f"from cold ones by {worst} (relative)")
    return out[False][2], out[True][2]


def cluster_run(torch, model, expect):
    """Run J: a two-replica ``Cluster`` of paged engines on the one card,
    both over one weight set, Equinox schedulers sharing their fairness
    state (``share_fairness_state``), routing ``least_kv``, a
    ``FlightRecorder`` on each replica.  The replicas' events, merged in
    the order the cluster fired them (one more recorder that every
    replica feeds), replay to the live counters exactly
    (``replay_cluster``); the per-replica traces, merged on the modeled
    clock (``merge_traces``), feed ``windowed_fairness``.  Returns the
    run's launch counts."""
    from repro_torch.core import make_scheduler
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.telemetry import (FlightRecorder,
                                               MultiObserver, merge_traces,
                                               scheduler_counters,
                                               windowed_fairness)

    cfg, params, cm, mope = model
    recs = [FlightRecorder(sample_every=4) for _ in range(2)]
    order = FlightRecorder()
    engines = [ServingEngine(
        cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
        params=params, max_len=512, cost_model=cm, seed=SEED + i,
        observer=MultiObserver(recs[i], order), device="cuda",
        backend="paged") for i in range(2)]
    cluster = Cluster(engines, policy="least_kv")
    reqs = requests(False)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = cluster.run(reqs, max_time=1e9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    summary = res.summary()
    check(summary["finished"] == len(reqs), f"run J: {summary['finished']}"
          f"/{len(reqs)} finished")
    check(all(n > 0 for n in summary["per_replica"]),
          f"run J: a replica served nothing: {summary['per_replica']}")
    check(engines[0].sched.ufc is engines[1].sched.ufc,
          "run J: the replicas do not share their fairness state")
    for name, want in expect.items():
        check(launches[name] > 0 if want else launches[name] == 0,
              f"run J: {name} launched {launches[name]} times")
    live = scheduler_counters(engines[0].sched)
    replayed = replay_cluster(order.trace(), [r.trace()["meta"]
                                              for r in recs],
                              cluster.routed_to)
    check(replayed == live, "run J: the replay of the merged trace "
          "differs from the live counters")
    wf = windowed_fairness(merge_traces([r.trace() for r in recs]))
    jains = wf["rolling_jain"]
    emit({"phase": "cluster", "run": "J", "model": cfg.name, "replicas": 2,
          "policy": "least_kv", "requests": len(reqs),
          "finished_per_replica": summary["per_replica"],
          "routed_per_replica": [sum(1 for i in res.routed_to.values()
                                     if i == k) for k in range(2)],
          "replay_equals_live": True, "counters": sorted(live),
          "events": len(order.trace()["events"]),
          "windowed_jain_min": wf["min_jain"],
          "windowed_jain_median": float(np.median(jains)) if jains
          else None, "windows": wf["n_windows"],
          "max_discrepancy": wf["max_discrepancy"],
          "jain": summary["jain"], "p50_ttft_model_s": summary["p50_ttft"],
          "wall_s": wall, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del engines, cluster, res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def replay_cluster(trace, metas, routed_to):
    """``replay_counters`` for replicas that share their fairness state:
    one scheduler per replica rebuilt from its trace's metadata (each keeps
    its own queues and, for Equinox, its own latency average, as live),
    the shared tables re-bound as the live cluster binds them, and every
    event of ``trace`` (the cluster's firing order) driven into the
    scheduler of the replica its request was routed to, as
    ``replay_counters`` drives one.  The reference defines replay for one
    replica; with shared tables the replicas' interleaving is part of the
    result, so the timestamp merge of ``merge_traces`` cannot replay."""
    from repro_torch.core.request import Request
    from repro_torch.serving import telemetry
    from repro_torch.serving.cluster import share_fairness_state

    scheds = [telemetry._scheduler_from_meta(m) for m in metas]
    share_fairness_state(scheds)
    stubs = {}
    for ev in trace["events"]:
        et, t = ev["type"], ev["t"]
        if et == "iteration":
            for rid in ev.get("produced", ()):
                stubs[rid].generated += 1
                scheds[routed_to[rid]].on_token(stubs[rid], t, 1)
            continue
        if et not in ("arrival", "admit", "preempt", "requeue", "complete"):
            continue
        sched = scheds[routed_to[ev["rid"]]]
        if et == "arrival":
            r = Request(rid=ev["rid"], client=ev["client"],
                        arrival=ev["arrival"], prompt_len=ev["prompt_len"],
                        output_len=0, weight=ev["weight"],
                        user=ev.get("user"), app=ev.get("app"),
                        interaction_id=ev.get("interaction_id"),
                        turn_index=ev.get("turn_index", 0))
            stubs[r.rid] = r
            sched.on_arrival(r, t)
            continue
        r = stubs[ev["rid"]]
        if et == "admit":
            try:
                sched.queues[r.account].remove(r)
            except ValueError:
                pass                      # as replay_counters: never twice
            r.cached_prefix = ev["cached_prefix"]
            r.pred_output_len = ev["pred_output_len"]
            r.pred_latency = ev["pred_latency"]
            r.pred_tps = ev["pred_tps"]
            r.pred_util = ev["pred_util"]
            sched.on_admit(r, t)
        elif et == "preempt":
            sched.on_preempt(r, t)
            r.generated = 0
            r.cached_prefix = 0
            sched.requeue_head(r)
        elif et == "requeue":
            sched.on_requeue(r, t)
        else:
            r.generated = ev["generated"]
            r.output_len = ev["output_len"]
            r.cached_prefix = ev["cached_prefix"]
            sched.on_complete(r, t, latency=ev["latency"], tps=ev["tps"],
                              util=ev["util"])
    return telemetry.scheduler_counters(scheds[0])


def first_token_check(firsts, ref, runs):
    """One run's first-token logits against another's for the same
    prompts and weights (``runs``: "D vs A": whole-prompt prefill through
    the flash kernel against chunked paged prefill through the paged
    kernels; "L vs D": int8 slot caches against bf16 ones, whose prefill
    reads no cache): equal argmax, max difference within DENSE_REL_TOL
    of the largest logit; rows equal bit for bit are counted."""
    worst, n_equal, n_bitwise = 0.0, 0, 0
    for rid, (toks, row) in firsts.items():
        ref_toks, ref_row = ref[rid]
        check(np.array_equal(toks, ref_toks), f"rid {rid}: prompts differ "
              f"between runs {runs}")
        rel = float(np.abs(row - ref_row).max() / np.abs(ref_row).max())
        worst = max(worst, rel)
        n_equal += int(np.argmax(row)) == int(np.argmax(ref_row))
        n_bitwise += int(np.array_equal(row, ref_row))
    emit({"phase": "first_token_check", "runs": runs,
          "requests": len(firsts), "argmax_equal": n_equal,
          "rows_bitwise_equal": n_bitwise, "max_rel_err": worst})
    check(n_equal == len(firsts), f"runs {runs}: first-token argmax "
          f"differs on {len(firsts) - n_equal} of {len(firsts)} requests")
    check(worst < DENSE_REL_TOL, f"runs {runs}: first-token logits differ "
          f"by {worst} (relative)")


def decode_consistency(torch, params, cfg, n=300):
    """prefill of n tokens against prefill of the first n - 1 followed by
    one decode step, as tests/test_decode_consistency.py does on the CPU:
    holds the SSD-scan kernel's final state (and the conv tail) against
    the ``ssd_step`` recurrence (run E), the flash kernel's prefill
    against decode over the slot cache (runs F and G; past the window,
    G's ring cache wraps; run N: the cross-attention's flash at Sq != Skv
    against split-K over the cached frames, pages of 4; run O: decode
    after the vision prefix).  An encoder-decoder's batch adds (1, T, d)
    standard-normal frames, a vision stack's (1, P, d) patches, drawn
    with numpy as that test draws them."""
    from repro_torch.models.model import decode_step, prefill

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(
        "cuda")
    batch = {"tokens": toks}
    extra = {"audio_stub": "frames", "vision_stub": "patch_embeds"}.get(
        cfg.frontend)
    if extra:
        batch[extra] = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)).to(
            "cuda")
    max_len = n + 4 + (cfg.n_frontend_tokens if extra == "patch_embeds"
                       else 0)
    full, _ = prefill(params, batch, cfg, max_len)
    _, cache = prefill(params, dict(batch, tokens=toks[:, :-1]), cfg,
                       max_len)
    step, _ = decode_step(params, toks[:, -1], cache, cfg)
    full, step = full.float()[0].cpu().numpy(), step.float()[0].cpu().numpy()
    rel = float(np.abs(step - full).max() / np.abs(full).max())
    same = int(np.argmax(step)) == int(np.argmax(full))
    SECONDS["reference_checks"] += time.perf_counter() - t0
    emit({"phase": "decode_consistency", "model": cfg.name, "prompt_len": n,
          "moe_impl": cfg.moe_impl if cfg.moe else None,
          "max_rel_err": rel, "argmax_equal": same,
          "finite": bool(np.isfinite(step).all() and np.isfinite(full).all())})
    check(np.isfinite(step).all() and np.isfinite(full).all(),
          "decode consistency: non-finite logits")
    check(rel < DENSE_REL_TOL and same, f"decode consistency: prefill + one "
          f"decode step differs from the longer prefill by {rel} "
          f"(relative), argmax equal: {same}")


def profile_window(torch, run, eng, reqs, window="decode"):
    """Where an iteration's time goes (the configuration of ``run``): all
    requests arrive at once.

    ``decode``: iterations run the prompts in (``prompts_in``: at most
    14), then 5 iterations are timed on the host clock and 1 more under
    ``torch.profiler`` for device time by kernel (the trace's processing
    takes most of a window's wall time).
    ``prefill``: the first iteration, profiled, its host time read under
    the profiler: the whole prompts of the requests
    it admits (later iterations decode until a request finishes).  The
    line carries the window's wall seconds (``window_s``).  Device busy share = device time per iteration / wall time
    per iteration.  An MLA stack's decode window counts the copies its
    profiled iterations make, by shape, and its batched products through
    ``OpCounts`` (their host time is not the one reported)."""
    from torch.profiler import ProfilerActivity, profile

    t_window = time.perf_counter()
    shapes = window == "decode" and eng.cfg.mla is not None
    warm, timed, steps = {"decode": (14, 5, 1),
                          "prefill": (0, 0, 1)}[window]
    for r in reqs:
        r.arrival = 0.0
        eng.submit(r)
    warmed = 0
    while warmed < warm and not prompts_in(eng):
        eng.step()
        warmed += 1
    torch.cuda.synchronize()
    rows = 0
    if window == "decode":
        t0 = time.perf_counter()
        for _ in range(timed):
            rows += len(eng.running)
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    n_log = len(eng.iter_log)
    # CUDA activity only: parsing CPU-side operator events took most of a
    # window's wall time (7 of 13.6 minutes of the smoke went to the
    # windows with them on; K's alone 13.8 s); an MLA stack's copies and
    # batched products are counted at the dispatcher instead
    ops = OpCounts(torch) if shapes else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, ops:
        t0 = time.perf_counter()
        for _ in range(steps):
            if window == "prefill":
                rows += len(eng.running)
            eng.step()
        torch.cuda.synchronize()
        if window == "prefill":
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    logged = eng.iter_log[n_log:]
    line = {"phase": "profile", "run": run, "window": window,
            "warmup_iterations": warmed, "iterations": steps,
            "rows_per_iteration": rows / (timed or steps),
            **profile_summary(prof, steps, wall_ms)}
    if shapes:
        # the copies a decode iteration makes, by the shapes copied (the
        # source's first), and those of W_UK or W_UV, the slices of wkv_b
        # that the absorbed decode multiplies by; the latent products
        line["aten_bmm_calls_per_iteration"] = ops.bmm / steps
        line["copies_per_iteration_by_shape"] = [
            {"shapes": [list(t) for t in key], "calls": n / steps}
            for key, n in ops.copies.most_common(8)]
        m = eng.cfg.mla
        w = {tuple(sorted((m.kv_lora_rank, eng.cfg.n_heads, d)))
             for d in (m.qk_nope_head_dim, m.v_head_dim)}
        line["wkv_b_slice_copies_per_iteration"] = sum(
            n for key, n in ops.copies.items()
            if tuple(sorted(key[0])) in w) / steps
    if reduced_of(eng.cfg):
        line["reduced"] = reduced_of(eng.cfg)
    if window == "decode" and eng.backend == "slots":
        # one more decode step over every slot, alone: the device memory
        # it takes beyond what is allocated (an f32 copy of a layer's
        # slot caches, had the attention made one)
        # MLA: an f32 copy of one layer's latent cache c
        f32_copy = max((sum(t[0].numel() * 4 for name, t in st.items()
                            if name in (("c",) if "c" in st else ("k", "v")))
                        for st in eng.cache["stages"].values()), default=0)
        if f32_copy:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng._decode_slots(np.zeros(eng.max_slots, np.int64))
            torch.cuda.synchronize()
            line["decode_step_extra_peak_bytes"] = \
                torch.cuda.max_memory_allocated() - base
            line["layer_cache_f32_copy_bytes"] = f32_copy
    if window == "prefill":
        line["longest_prompt_prefilled"] = max(
            r.prompt_len for r in eng.running + eng.finished
            if r.prefill_done >= r.prompt_len)
        line["prompt_rows_per_iteration"] = [n for _, n, _ in logged]
        line["model_step_ms_profiled"] = [s * 1e3 for s, _, _ in logged]
        check(sum(n for _, n, _ in logged) > 0,
              f"run {run}: the prefill window ran no prompt tokens")
    line["window_s"] = time.perf_counter() - t_window
    emit(line)
    SECONDS["profile_windows"] += line["window_s"]
    return line


class OpCounts:
    """A context that counts, at the dispatcher, the copies made
    (``aten.copy_``, ``clone`` and ``_to_copy``, by the source's and the
    result's shapes) and the ``aten.bmm`` calls of what runs inside it."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        aten = torch.ops.aten
        copies = (aten.copy_, aten.clone, aten._to_copy)
        counts = self
        self.copies, self.bmm = Counter(), 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                packet = func.overloadpacket
                if packet in copies:
                    src = args[1] if packet is aten.copy_ else args[0]
                    counts.copies[(tuple(src.shape), tuple(out.shape))] += 1
                elif packet is aten.bmm:
                    counts.bmm += 1
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def prompts_in(eng):
    """Whether a decode window may start: every running request past its
    prompt, and every slot taken or none waiting."""
    return bool(eng.running) and all(
        r.prefill_done >= r.prompt_len for r in eng.running) and (
        len(eng.running) >= eng.max_slots or not eng.sched.has_waiting())


def device_kernels(prof):
    """A profile's device kernels; a record_function label's span on the
    device timeline (a user annotation) is not one."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]


def device_us(e):
    """An event's own device µs."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_summary(prof, steps, wall_ms):
    """A profiled window's device time, busy share, launches, the port's
    kernels and the top device kernels, per iteration (``steps`` of them,
    ``wall_ms`` each on the host clock)."""
    events = device_kernels(prof)
    device_ms = sum(device_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=device_us, reverse=True)[:8]
    ours = defaultdict(lambda: [0.0, 0.0])        # the port's own kernels
    for e in events:
        if any(n in e.key for n in ("paged_attention", "paged_plan",
                                    "flash_attention", "flash_bwd",
                                    "ssd_scan", "ssd_bwd")):
            name = e.key[:80]
            ours[name][0] += device_us(e) / 1e3 / steps
            ours[name][1] += e.count / steps
    return {"wall_ms_per_iteration": wall_ms,
            "device_ms_per_iteration": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_iteration":
                sum(e.count for e in events) / steps,
            "port_kernels_ms_per_iteration": {
                k: v[0] for k, v in sorted(ours.items())},
            "port_kernel_launches_per_iteration": {
                k: v[1] for k, v in sorted(ours.items())},
            "top_device_kernels": [
                {"name": e.key[:80],
                 "ms_per_iteration": device_us(e) / 1e3 / steps,
                 "calls_per_iteration": e.count / steps} for e in top]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def plain_attention(torch, q, k, v, window, heads=8, causal=True):
    """Causal (and windowed) attention of one prompt, or (``causal``
    False) every query row over every key, scores in f32, ``heads`` query
    heads at a time.  q (S, Hq, D), k (Skv, Hkv, D), v (Skv, Hkv, Dv)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    pos = torch.arange(S, device=q.device)
    kpos = torch.arange(k.shape[0], device=q.device)
    keep = torch.ones((S, k.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos[None] <= pos[:, None]
    if window:
        keep &= kpos[None] > pos[:, None] - window
    out = torch.empty((S, H, v.shape[-1]), device=q.device)
    for h in range(0, H, heads):
        s = torch.einsum("shd,thd->hst", q[:, h:h + heads].float(),
                         k[:, h:h + heads]) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
        out[:, h:h + heads] = torch.einsum("hst,thd->shd", p,
                                           v[:, h:h + heads])
    return out.to(q.dtype)


def gqa_plain(torch, lp, h, pos, cfg, window, causal=True, kv=None):
    """One attention layer's output for one prompt h (S, d): the rotary
    projections, attention by ``plain_attention``, ``wo``.  ``kv``: the
    encoder's output (T, d), attended without rotary embedding and
    without a mask (Whisper's cross-attention; ``lp`` its ``cross``)."""
    from repro_torch.models.layers import apply_rope

    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    q = (h @ lp["wq"].reshape(cfg.d_model, -1)).reshape(len(h), H, hd)
    src = h if kv is None else kv
    k, v = ((src @ lp[w].reshape(cfg.d_model, -1)).reshape(
        len(src), -1, hd) for w in ("wk", "wv"))
    if kv is None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = plain_attention(torch, q, k, v, window,
                        causal=causal and kv is None)
    return o.reshape(len(h), -1) @ lp["wo"].reshape(H * hd, -1)


def whisper_plain(torch, params, cfg, frames, toks):
    """Last-token logits of one Whisper request, plain: the encoder over
    ``frames`` (T, d) and the decoder over ``toks``, each attention by
    ``gqa_plain`` (the encoder's and the cross-attention not causal), the
    MLPs and norms the port's."""
    from repro_torch.models.layers import dtype_of, embed, rmsnorm, unembed
    from repro_torch.models.model import _sinusoid, ffn_forward, layer_params

    dt = dtype_of(cfg)

    def block(lp, x, pos, causal, enc=None):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + gqa_plain(torch, lp["attn"], h, pos, cfg, 0, causal=causal)
        if enc is not None:
            hc = rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
            x = x + gqa_plain(torch, lp["cross"], hc, pos, cfg, 0, kv=enc)
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        return x + ffn_forward(lp["ffn"], h2, cfg, False)

    T = frames.shape[0]
    pos = torch.arange(T, device=frames.device)
    x = frames.to(dt) + _sinusoid(pos, cfg.d_model).to(dt)
    st = params["enc"]["stages"]["stage_0"]
    for i in range(cfg.n_encoder_layers):
        x = block(layer_params(st, i), x, pos, causal=False)
    enc = rmsnorm(params["enc"]["final_norm"], x, cfg.norm_eps)
    pos = torch.arange(len(toks), device=frames.device)
    x = embed(params["embed"], toks)
    x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    st = params["stages"]["stage_0"]
    for i in range(cfg.n_layers):
        x = block(layer_params(st, i), x, pos, causal=True, enc=enc)
    return unembed(params["embed"], rmsnorm(params["final_norm"], x[-1:],
                                            cfg.norm_eps)).float()[0]


def mla_plain(torch, lp, h, pos, cfg, window):
    """One MLA layer's attention output for one prompt h (S, d), expanded
    as in prefill: the port's projections (``_mla_qkv``), attention by
    ``plain_attention``."""
    from repro_torch.models.attention import _mla_qkv

    m, H = cfg.mla, cfg.n_heads
    q_nope, q_rope, c, k_rope = _mla_qkv(lp, h[None], pos[None], cfg)
    kv = (c[0] @ lp["wkv_b"].reshape(m.kv_lora_rank, -1)).reshape(
        -1, H, m.qk_nope_head_dim + m.v_head_dim)
    S = h.shape[0]
    q = torch.cat([q_nope[0], q_rope[0]], -1)
    k = torch.cat([kv[..., :m.qk_nope_head_dim], k_rope[0][:, None].expand(
        S, H, m.qk_rope_head_dim)], -1)
    o = plain_attention(torch, q, k, kv[..., m.qk_nope_head_dim:], window)
    return o.reshape(S, -1) @ lp["wo"].reshape(H * m.v_head_dim, -1)


def dense_check(torch, params, cfg, firsts, n=3, rids=None):
    """The served first-token logits of ``n`` requests (or of ``rids``)
    against a plain forward of the same weights, one prompt at a time:
    attention without pools or kernels (MLA expanded, as in prefill), the
    port's RG-LRU block (it has no kernel), MLP and MoE FFN.  A vision
    stack's request starts with the engine's patches for it (standard
    normals from ``default_rng(rid)``, in the model dtype)."""
    from repro_torch.configs.base import ATTN_MLA, RGLRU
    from repro_torch.models.layers import embed, rmsnorm, unembed
    from repro_torch.models.model import (ffn_forward, layer_params,
                                          model_stages, window_for)
    from repro_torch.models.rglru import rglru_prefill

    t0 = time.perf_counter()
    worst = 0.0
    with torch.no_grad():
        for rid in rids or sorted(firsts)[:n]:
            toks, served = firsts[rid]
            x = embed(params["embed"], torch.as_tensor(toks, device="cuda"))
            if cfg.frontend == "vision_stub":
                patches = np.random.default_rng(rid).standard_normal(
                    (cfg.n_frontend_tokens, cfg.d_model))
                x = torch.cat([torch.from_numpy(patches).to(
                    "cuda", x.dtype), x])
            S = x.shape[0]
            pos = torch.arange(S, device="cuda")
            for si, (kind, moe_flag, count) in enumerate(model_stages(cfg)):
                st = params["stages"][f"stage_{si}"]
                window = window_for(cfg, kind)
                for i in range(count):
                    h = rmsnorm({"scale": st["ln1"]["scale"][i]}, x,
                                cfg.norm_eps)
                    if kind == ATTN_MLA:
                        x = x + mla_plain(torch, layer_params(st["attn"], i),
                                          h, pos, cfg, window)
                    elif kind == RGLRU:
                        x = x + rglru_prefill(layer_params(st["attn"], i),
                                              h[None], cfg)[0][0]
                    else:
                        x = x + gqa_plain(torch, layer_params(st["attn"], i),
                                          h, pos, cfg, window)
                    h2 = rmsnorm({"scale": st["ln2"]["scale"][i]}, x,
                                 cfg.norm_eps)
                    x = x + ffn_forward(layer_params(st["ffn"], i), h2, cfg,
                                        moe_flag)
            ref = unembed(params["embed"], rmsnorm(
                params["final_norm"], x[-1:], cfg.norm_eps)).float()[0]
            ref = ref.cpu().numpy()
            rel = float(np.abs(served - ref).max() / np.abs(ref).max())
            worst = max(worst, rel)
            emit({"phase": "dense_check", "model": cfg.name, "rid": rid,
                  "prompt_len": len(toks), "positions": S,
                  "max_rel_err": rel,
                  "argmax_equal": int(np.argmax(served)) == int(np.argmax(ref))})
    SECONDS["reference_checks"] += time.perf_counter() - t0
    check(worst < DENSE_REL_TOL, f"{cfg.name}: served first-token logits "
          f"differ from the plain forward by {worst} (relative)")


if __name__ == "__main__":
    sys.exit(main())
