"""Latent-plan distribution, discrete branch (port of
hulc_tpu/ops/plan_distributions.py:27-147).

The plan is ``category_size`` independent categoricals over ``class_size``
classes, flattened to a one-hot vector. ``sample`` draws as
``jax.random.categorical`` does: argmax over the class axis of
``logits + gumbel``. The Gumbel noise comes from the caller's
``torch.Generator`` unless the caller passes it (tests pass the noise JAX
drew). ``rsample`` is the straight-through sample, ``kl`` / ``balanced_kl``
the DreamerV2 balanced KL, all plain PyTorch. ``rsample_balanced_kl`` is
what a training step calls: both at once, for the posterior's sample and
its KL to the prior; on CUDA tensors it is a ``torch.autograd.Function``
whose forward and backward are the kernels of ``csrc/plan_kl.cu``. Its
noise is Gumbel noise (``gumbel=``) or uniforms (``uniform=``, or the
generator's ``torch.rand`` draw) that the forward kernel turns into Gumbel
noise itself, as ``gumbel_of_uniform`` does: from the draw to the sample
and the KL, one launch. The continuous (Normal) plan waits for a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from hulc_tpu_torch import kernels


class DiscretePlanState(NamedTuple):
    """Unnormalized logits, flattened: (..., category_size * class_size)."""

    logit: torch.Tensor


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise of uniforms u in [0, 1): -log(-log u), u clamped
    at the smallest normal float (jax.random.gumbel draws u in [tiny, 1))."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_noise(shape, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise from one ``torch.rand`` draw of ``generator``."""
    return gumbel_of_uniform(torch.rand(shape, generator=generator, device=device))


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

    def rsample(
        self,
        state: DiscretePlanState,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Straight-through sample, flattened: ``(one_hot + p) - sg(p)``."""
        logits = self._grid_logits(state)
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        one_hot = F.one_hot(torch.argmax(gumbel + logits, dim=-1), self.class_size).float()
        probs = torch.softmax(logits, dim=-1)
        st = one_hot + probs - probs.detach()
        return st.reshape(st.shape[:-2] + (self.plan_dim,))

    def kl(self, p: DiscretePlanState, q: DiscretePlanState) -> torch.Tensor:
        """KL(p || q) per batch element (summed over the plan), fp32."""
        lp = torch.log_softmax(self._grid_logits(p), dim=-1)
        lq = torch.log_softmax(self._grid_logits(q), dim=-1)
        return (torch.exp(lp) * (lp - lq)).sum(dim=-1).sum(dim=-1)

    def balanced_kl(
        self, posterior: DiscretePlanState, prior: DiscretePlanState, alpha: float, per_sample: bool = False
    ) -> torch.Tensor:
        """alpha * KL(sg[post] || prior) + (1 - alpha) * KL(post || sg[prior]);
        the mean over the batch unless ``per_sample``."""
        kl_lhs = self.kl(DiscretePlanState(posterior.logit.detach()), prior)
        kl_rhs = self.kl(posterior, DiscretePlanState(prior.logit.detach()))
        out = alpha * kl_lhs + (1.0 - alpha) * kl_rhs
        return out if per_sample else out.mean()

    def rsample_balanced_kl(
        self,
        posterior: DiscretePlanState,
        prior: DiscretePlanState,
        alpha: float,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        uniform: Optional[torch.Tensor] = None,
        use_kernels: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(straight-through sample of the posterior (B, plan_dim), per-sample
        balanced KL (B,)). The noise: ``gumbel`` (B, category_size,
        class_size) Gumbel noise, or ``uniform`` of that shape in [0, 1), or
        else one ``torch.rand`` draw of ``generator`` (the draw
        ``gumbel_noise`` makes); uniforms go through ``gumbel_of_uniform``.
        ``use_kernels=False`` runs the plain version on any device; it exists
        to hold the kernels against it on the card."""
        if gumbel is not None and uniform is not None:
            raise ValueError("pass gumbel or uniform noise, not both")
        post, pri = self._grid_logits(posterior), self._grid_logits(prior)
        if gumbel is None and uniform is None:
            uniform = torch.rand(post.shape, generator=generator, device=post.device)
        if not use_kernels or post.device.type == "cpu":
            gumbel = gumbel_of_uniform(uniform) if gumbel is None else gumbel
            sample = self.rsample(posterior, gumbel=gumbel)
            return sample, self.balanced_kl(posterior, prior, alpha, per_sample=True)
        noise_is_uniform = gumbel is None
        noise = uniform if noise_is_uniform else gumbel
        tensors = [t.contiguous() for t in (post, pri, noise.float())]
        for name, t in zip(("posterior", "prior", "uniform" if noise_is_uniform else "gumbel"), tensors):
            kernels.require_cuda_tensor(name, t, torch.float32, 3)
            if t.shape != post.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(post.shape)}")
        st, kl = _PlanStKL.apply(*tensors, float(alpha), noise_is_uniform)
        return st.reshape(st.shape[:-2] + (self.plan_dim,)), kl


class _PlanStKL(torch.autograd.Function):
    """The kernels of csrc/plan_kl.cu: (post, prior, noise) grids ->
    (straight-through sample, per-sample balanced KL), the noise Gumbel or,
    with ``noise_is_uniform``, uniforms; and their backward."""

    @staticmethod
    def forward(ctx, post, prior, noise, alpha, noise_is_uniform):
        b, cats, classes = post.shape
        st = torch.empty_like(post)
        kl = torch.empty(b, dtype=torch.float32, device=post.device)
        kernels.PLAN_ST_KL_FWD(
            post.device, post.data_ptr(), prior.data_ptr(), noise.data_ptr(), st.data_ptr(),
            kl.data_ptr(), b, cats, classes, int(noise_is_uniform), alpha, 1.0 - alpha,
        )
        ctx.save_for_backward(post, prior)
        ctx.alpha = alpha
        return st, kl

    @staticmethod
    def backward(ctx, d_st, d_kl):
        post, prior = ctx.saved_tensors
        b, cats, classes = post.shape
        d_st = torch.zeros_like(post) if d_st is None else d_st.float().contiguous()
        d_kl = torch.zeros(b, device=post.device) if d_kl is None else d_kl.float().contiguous()
        d_post, d_prior = torch.empty_like(post), torch.empty_like(prior)
        kernels.PLAN_ST_KL_BWD(
            post.device, post.data_ptr(), prior.data_ptr(), d_st.data_ptr(), d_kl.data_ptr(),
            d_post.data_ptr(), d_prior.data_ptr(), b, cats, classes, ctx.alpha, 1.0 - ctx.alpha,
        )
        return d_post, d_prior, None, None, None
