"""optax's `chain(clip_by_global_norm(max_norm), adam(lr_schedule,
eps=1e-5))` (cpr_tpu/train/ppo.py:317-326) over one flat float32
parameter vector: the plain twin of kernel K11-adam, and its dispatch.

The arithmetic is optax 0.2.6's, in float32 (optax/transforms/
_clipping.py:91-105, _src/transform.py:282-306 and 968-990,
tree_utils/_tree_math.py:350-395):

    norm  = sqrt(sum(g * g))                       over every parameter
    g     = g                      if norm < max_norm
            (g / norm) * max_norm  otherwise
    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * (g * g) + b2 * nu
    c     = count + 1
    u     = (mu / (1 - b1**c)) / (sqrt(nu / (1 - b2**c)) + eps)
    p     = p + (-lr(count)) * u

`lr` is read at the count before the increment (scale_by_schedule's own
count, which moves with adam's). The count and the scalars derived from
it live on the host, so a step costs no device sync. Not
`torch.nn.utils.clip_grad_norm_` (max_norm / (norm + 1e-6)) and not
`torch.optim.Adam` (it rounds otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """The optimizer: `lr` is a float or a schedule `count -> float32`."""

    lr: float | Callable
    max_grad_norm: float = 0.5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-5

    def init(self, flat: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat))

    def scalars(self, count: int) -> dict:
        """The float32 scalars of the step that follows `count` steps."""
        f32 = np.float32
        lr = self.lr(count) if callable(self.lr) else self.lr
        c = f32(count + 1)
        return dict(
            neg_lr=float(f32(-f32(lr))),
            bc1=float(f32(1) - f32(self.b1) ** c),
            bc2=float(f32(1) - f32(self.b2) ** c),
            b1=float(f32(self.b1)), b2=float(f32(self.b2)),
            omb1=float(f32(1 - self.b1)), omb2=float(f32(1 - self.b2)),
            eps=float(f32(self.eps)), max_norm=float(f32(self.max_grad_norm)))

    def step(self, flat: torch.Tensor, grad: torch.Tensor,
             state: AdamState) -> AdamState:
        """One step: `flat`, `state.mu` and `state.nu` are updated in
        place and the count advances. K11-adam on a CUDA tensor, the
        plain twin on a CPU one."""
        s = self.scalars(state.count)
        if flat.is_cuda:
            from cpr_tpu_torch import kernels
            kernels.adam(flat, grad, state.mu, state.nu, **s)
        else:
            step_plain(flat, grad, state.mu, state.nu, **s)
        state.count += 1
        return state


def step_plain(flat, grad, mu, nu, *, neg_lr, bc1, bc2, b1, b2, omb1, omb2,
               eps, max_norm):
    """Plain twin of K11-adam: one clipped Adam step, in place."""
    norm = torch.sqrt(torch.sum(grad * grad))
    g = torch.where(norm < max_norm, grad, grad / norm * max_norm)
    mu.copy_(omb1 * g + b1 * mu)
    nu.copy_(omb2 * (g * g) + b2 * nu)
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    flat.add_(neg_lr * u)
    return norm
