"""MoPE — Mixture of Prediction Experts (paper §6; DESIGN.md §5).

``MoPE.predict(req)`` fills the request's predicted output tokens,
latency, TPS and utilization — the four holistic-fairness inputs the
dual counters (paper §3, DESIGN.md §2) need *before* execution: a
deterministic router picks a length regime, a per-regime expert predicts
output tokens, and the metric map (``repro_torch.predictor.metric_map``) turns
(prompt, predicted output) into latency/TPS/Util.  ``observe`` is
Algorithm 1 line 20: actual metrics recalibrate the map and a per-regime
bias online.  In a cluster (DESIGN.md §7) one predictor instance is
shared by all replicas, so recalibration is fleet-wide.
Baselines: ``SingleProxy`` (one unified expert, the μ-Serve-style
baseline [31]) and ``Oracle`` (perfect lengths — Table 1's upper bound).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.request import Request
from repro_torch.predictor.experts import predict_tokens, train_expert
from repro_torch.predictor.features import featurize, featurize_batch
from repro_torch.predictor.metric_map import MetricMap
from repro_torch.predictor.router import regime_of, train_router
from repro_torch.serving.costmodel import CostModel


class BasePredictor:
    """Shared predict/map/observe plumbing (subclasses implement tokens).

    Besides the paper's metric-map calibration, ``observe`` keeps an
    online per-regime multiplicative bias (EMA of actual/predicted output
    length) — the live-traffic half of the Algorithm-1 feedback loop that
    adapts the offline-trained experts to workload drift.
    """

    def __init__(self, cost_model: CostModel, calibrate: bool = True,
                 bias_ema: float = 0.05):
        self.metric_map = MetricMap(cost_model)
        self.calibrate = calibrate
        self.bias_ema = bias_ema
        self._bias = {}

    def predict_tokens(self, req: Request) -> float:
        raise NotImplementedError

    def _regime(self, req: Request) -> int:
        return 0

    def predict(self, req: Request) -> Request:
        raw = float(self.predict_tokens(req))
        # keep the pre-bias prediction on the request: observe() must
        # reconcile against the prediction *as made*, not against
        # pred_output_len un-scaled by whatever the bias is at completion
        # time (it drifts under concurrent completions)
        req._pred_raw = raw
        # stamp the routing regime (MoPE expert index; 0 for single-proxy
        # predictors) so the flight recorder's admit events can audit
        # per-expert prediction accuracy offline (DESIGN.md §14)
        req._pred_regime = self._regime(req)
        if self.calibrate:
            raw *= self._bias.get(self._regime(req), 1.0)
        req.pred_output_len = max(raw, 1.0)
        lat, tps, util = self.metric_map.predict(req.prompt_len,
                                                 req.pred_output_len)
        req.pred_latency, req.pred_tps, req.pred_util = lat, tps, util
        return req

    def observe(self, req: Request, *, latency: float, tps: float,
                util: float):
        """Algorithm 1 line 20: refresh P.map (and bias) with actuals."""
        self.metric_map.update(req.prompt_len, req.output_len,
                               latency=latency, tps=tps, util=util)
        if self.calibrate and req.pred_output_len:
            r = self._regime(req)
            cal = self._bias.get(r, 1.0)
            raw = getattr(req, "_pred_raw", None)
            if raw is None:
                # legacy request predicted before this fix: best effort —
                # recover the raw prediction with the current bias
                raw = req.pred_output_len / self._bias.get(r, 1.0)
            ratio = req.output_len / max(raw, 1.0)
            ratio = float(np.clip(ratio, 0.1, 10.0))
            self._bias[r] = (1 - self.bias_ema) * cal + self.bias_ema * ratio


class MoPE(BasePredictor):
    def __init__(self, cost_model: CostModel, corpus, n_experts: int = 3,
                 seed: int = 0, epochs: int = 40, calibrate: bool = True):
        super().__init__(cost_model, calibrate=calibrate)
        self.n_experts = n_experts
        self.router = train_router(corpus, n_experts, seed)
        self.experts = []
        outs = np.array([o for _, _, o in corpus], np.float64)
        regimes = np.array([regime_of(o, self.router.boundaries)
                            for o in outs])
        feats = featurize_batch([(kw, pl) for kw, pl, _ in corpus])
        for r in range(n_experts):
            m = regimes == r
            params, _ = train_expert(feats[m], outs[m], seed=seed + r,
                                     epochs=epochs)
            self.experts.append(params)

    def _regime(self, req: Request) -> int:
        return self.router.classify(req.keywords, req.prompt_len)

    def predict_tokens(self, req: Request) -> float:
        r = self._regime(req)
        f = featurize(req.keywords, req.prompt_len)[None]
        return float(predict_tokens(self.experts[r], f)[0])


class SingleProxy(BasePredictor):
    """One unified regression model over the whole corpus."""

    def __init__(self, cost_model: CostModel, corpus, seed: int = 0,
                 epochs: int = 40, calibrate: bool = True):
        super().__init__(cost_model, calibrate=calibrate)
        outs = np.array([o for _, _, o in corpus], np.float64)
        feats = featurize_batch([(kw, pl) for kw, pl, _ in corpus])
        self.params, _ = train_expert(feats, outs, seed=seed, epochs=epochs)

    def predict_tokens(self, req: Request) -> float:
        f = featurize(req.keywords, req.prompt_len)[None]
        return float(predict_tokens(self.params, f)[0])


class Oracle(BasePredictor):
    def predict_tokens(self, req: Request) -> float:
        return float(req.output_len)


class ScaledOracle(BasePredictor):
    """Oracle scaled by a constant factor — a controllable misprediction
    stressor.  ``factor < 1`` under-predicts output lengths (so KV
    reservations systematically under-commit and the preemption /
    reconciliation path, DESIGN.md §10, must absorb the difference);
    ``calibrate=False`` by default so the online bias EMA does not learn
    the error away mid-benchmark."""

    def __init__(self, cost_model: CostModel, factor: float = 0.25,
                 calibrate: bool = False):
        super().__init__(cost_model, calibrate=calibrate)
        self.factor = factor

    def predict_tokens(self, req: Request) -> float:
        return max(float(req.output_len) * self.factor, 1.0)


def l1_error(predictor: BasePredictor, corpus) -> float:
    """Mean absolute token error (paper Fig. 7a: 80 → 33 → 25)."""
    errs = []
    for kw, pl, o in corpus:
        req = Request(rid=-1, client="eval", arrival=0.0, prompt_len=pl,
                      output_len=o, keywords=kw)
        errs.append(abs(predictor.predict_tokens(req) - o))
    return float(np.mean(errs))
