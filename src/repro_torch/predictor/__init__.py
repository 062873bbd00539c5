from repro_torch.predictor.mope import (MoPE, Oracle, ScaledOracle, SingleProxy,
                                  l1_error)
from repro_torch.predictor.router import Router, router_accuracy, train_router

__all__ = ["MoPE", "Oracle", "ScaledOracle", "SingleProxy", "l1_error",
           "Router", "router_accuracy", "train_router"]
