"""Latent-plan distribution, discrete branch (port of
hulc_tpu/ops/plan_distributions.py:27-120).

The plan is ``category_size`` independent categoricals over ``class_size``
classes, flattened to a one-hot vector. ``sample`` draws as
``jax.random.categorical`` does: argmax over the class axis of
``logits + gumbel``. The Gumbel noise comes from the caller's
``torch.Generator`` unless the caller passes it (tests pass the noise JAX
drew). The straight-through ``rsample`` and the balanced KL wait for the
training slice; so does the continuous (Normal) plan.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class DiscretePlanState(NamedTuple):
    """Unnormalized logits, flattened: (..., category_size * class_size)."""

    logit: torch.Tensor


def gumbel_noise(shape, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log u) with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass(frozen=True)
class PlanDistribution:
    kind: str = "discrete"
    category_size: int = 32
    class_size: int = 32

    def __post_init__(self):
        if self.kind != "discrete":
            raise ValueError(f"plan distribution {self.kind!r} is not ported yet; only 'discrete' is")

    @property
    def plan_dim(self) -> int:
        return self.category_size * self.class_size

    @property
    def state_dim(self) -> int:
        return self.category_size * self.class_size

    def make_state(self, x: torch.Tensor) -> DiscretePlanState:
        return DiscretePlanState(logit=x)

    def _grid_logits(self, state: DiscretePlanState) -> torch.Tensor:
        s = state.logit.float()
        return s.reshape(s.shape[:-1] + (self.category_size, self.class_size))

    def _flat_one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        one_hot = F.one_hot(idx, self.class_size).float()
        return one_hot.reshape(one_hot.shape[:-2] + (self.plan_dim,))

    def sample(
        self,
        state: DiscretePlanState,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Non-reparameterized sample, flattened to (..., plan_dim).

        gumbel: optional (..., category_size, class_size) noise.
        """
        logits = self._grid_logits(state)
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        return self._flat_one_hot(torch.argmax(gumbel + logits, dim=-1))

    def mode(self, state: DiscretePlanState) -> torch.Tensor:
        """Deterministic plan: the argmax one-hot, flattened."""
        return self._flat_one_hot(torch.argmax(self._grid_logits(state), dim=-1))
