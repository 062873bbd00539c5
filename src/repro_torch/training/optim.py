"""AdamW over a parameter tree, with the reference's semantics.

Port of ``repro/training/optim.py`` (the JAX package's own optimizer, no
optax): f32 first and second moments for every parameter, bf16 ones
included; the global-norm clip applied to the gradients before the
moments; bias correction with the step counted from 1; weight decay added
to the update in f32 (``u + wd * p``); the new parameter computed in f32
and cast back to the parameter's dtype.  ``torch.optim.AdamW`` is not
this optimizer (it keeps bf16 moments for bf16 parameters and has no
clip), so the update is written out over the tree.

The state is ``{"mu": tree, "nu": tree, "step": int}`` as in the
reference.  ``update`` writes the parameters and moments in place (under
``torch.no_grad``), so a step at full width holds no second copy of
either; it returns the same objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch


def tree_leaves(tree):
    """Leaves of a nested dict in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0            # global-norm clip; 0 = off
    # the clip's norm of the gradient leaves (a list, in tree order);
    # None: ``global_norm``, the leaves being whole
    norm: Optional[Callable[[list], torch.Tensor]] = None

    def init(self, params):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return {"mu": zeros, "nu": tree_map(torch.zeros_like, zeros),
                "step": 0}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: ``params`` and the moments updated in place from
        ``grads`` (a tree shaped as ``params``).  Returns (params, state).
        Runs under the profiler label ``adamw_update``, so a profiled step
        shows the optimizer's device time."""
        with torch.profiler.record_function("adamw_update"):
            return self._update(grads, state, params)

    def _update(self, grads, state, params):
        step = state["step"] + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        g_leaves = tree_leaves(grads)
        scale = None
        if self.grad_clip:
            gnorm = (self.norm or global_norm)(g_leaves)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        # bias corrections in f32, as the reference's (step as f32)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        for p, g, mu, nu in zip(tree_leaves(params), g_leaves,
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            g = g.float()
            if scale is not None:
                g = g * scale
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        state["step"] = step
        return params, state


def adam(lr=1e-3, **kw):
    return AdamW(lr=lr, weight_decay=0.0, **kw)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device)."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in leaves))


def cosine_schedule(peak_lr, warmup_steps, total_steps, floor=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``floor * peak_lr`` at ``total_steps``; computed in f32 as the
    reference's.  Returns a function of the step (counted from 1)."""
    def sched(step) -> float:
        f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        step = f(float(step))
        if step < warmup_steps:
            return float(f(peak_lr) * step / max(warmup_steps, 1))
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return float(f(peak_lr) * (floor + (1 - floor) * 0.5
                                   * (1 + torch.cos(math.pi * frac))))
    return sched
