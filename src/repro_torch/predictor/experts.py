"""Regression experts: small MLPs trained with L1 loss on
log-output-length (DESIGN.md §3).  Port of ``repro/predictor/experts.py``.

The experts are host-side scheduler state (a 3-layer ReLU MLP on a
featurized request), so they live on the CPU: predictions are read by
the scheduler loop on the host.  Training uses ``torch.optim.Adam`` with
the reference optimizer's lr, betas and eps; its bias correction is the
same.  Random bits differ from JAX's, so trained experts are comparable
in error, not equal; ``repro_torch.weights.params_from_numpy`` carries
JAX-trained experts over exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.predictor.features import DIM

_LR, _BETAS, _EPS = 3e-3, (0.9, 0.999), 1e-8


def expert_init(generator: torch.Generator, hidden=64, dim=DIM):
    s1 = (2.0 / dim) ** 0.5
    s2 = (2.0 / hidden) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    return {
        "w1": normal(dim, hidden) * s1,
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, hidden) * s2,
        "b2": torch.zeros(hidden),
        "w3": normal(hidden, 1) * s2,
        "b3": torch.zeros(1),
    }


def expert_apply(params, x):
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"] + params["b3"])[..., 0]   # log-length


def train_expert(feats: np.ndarray, lengths: np.ndarray, *, seed=0,
                 epochs=40, batch=256, hidden=64):
    """Returns (params, final L1 loss in log space): the mean loss of the
    last epoch's minibatches, as the reference reports it."""
    x = torch.as_tensor(np.asarray(feats), dtype=torch.float32)
    y_log = torch.log1p(torch.as_tensor(np.asarray(lengths),
                                        dtype=torch.float32))
    n = x.shape[0]
    n_batches = max(n // batch, 1)
    params = expert_init(torch.Generator().manual_seed(seed), hidden=hidden)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=_LR, betas=_BETAS, eps=_EPS)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(epochs):
        perm = rng.permutation(n)[: n_batches * batch]
        perm = torch.as_tensor(perm.reshape(n_batches, batch))
        losses = []
        for idx in perm:
            batch_loss = (expert_apply(params, x[idx]) - y_log[idx]).abs() \
                .mean()
            opt.zero_grad()
            batch_loss.backward()
            opt.step()
            losses.append(batch_loss.detach())
        loss = torch.stack(losses).mean()
    return {k: p.detach() for k, p in params.items()}, float(loss)


def predict_tokens(params, feats: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        out = expert_apply(params, torch.as_tensor(np.asarray(feats),
                                                   dtype=torch.float32))
    return np.maximum(np.expm1(out.numpy()), 1.0)
