"""Token → (latency, TPS, util) metric map — the paper's ``P.map``.

Seeded from offline profiling (here: the analytic cost model over a grid
of (prompt_len, output_len), standing in for the paper's lmsys-chat-1m
profiling run) and *calibrated online* with observed metrics after every
completed batch (Algorithm 1, line 20) via per-bin EMA.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.costmodel import CostModel

_BINS = np.array([16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 1 << 30])


class MetricMap:
    def __init__(self, cost_model: CostModel, typical_batch: int = 8,
                 ema: float = 0.2):
        self.cm = cost_model
        self.ema = ema
        n = len(_BINS)
        self.latency = np.zeros(n)
        self.tps = np.zeros(n)
        self.util = np.zeros(n)
        self._seed_offline(typical_batch)

    def _bin(self, total_tokens: float) -> int:
        return int(np.searchsorted(_BINS, total_tokens, side="left"))

    def _seed_offline(self, b: int):
        """Offline profile: model each bin's representative request served
        inside a typical batch of size ``b``."""
        for i, edge in enumerate(_BINS):
            tot = min(edge, 8192)
            p_len = max(int(tot * 0.4), 1)
            o_len = max(int(tot * 0.6), 1)
            t_pref = self.cm.prefill_time(p_len)
            ctxs = [p_len + o_len // 2] * b
            t_dec = self.cm.decode_step_time(ctxs) / b  # per-request share
            lat = t_pref + o_len * t_dec
            self.latency[i] = lat
            self.tps[i] = (p_len + o_len) / max(lat, 1e-9)
            self.util[i] = self.cm.mfu(p_len + o_len, lat * b)

    def predict(self, prompt_len: float, pred_output: float):
        """Returns (latency, tps, util) for a request."""
        i = self._bin(prompt_len + pred_output)
        return float(self.latency[i]), float(self.tps[i]), float(self.util[i])

    def update(self, prompt_len: float, output_len: float, *, latency: float,
               tps: float, util: float):
        """Online calibration from observed post-execution metrics."""
        i = self._bin(prompt_len + output_len)
        a = self.ema
        self.latency[i] = (1 - a) * self.latency[i] + a * latency
        self.tps[i] = (1 - a) * self.tps[i] + a * tps
        self.util[i] = (1 - a) * self.util[i] + a * util
