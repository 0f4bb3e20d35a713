"""Latent-plan distributions (port of hulc_tpu/ops/plan_distributions.py:27-150).

The plan is either discrete or continuous.

* ``discrete``: ``category_size`` independent categoricals over
  ``class_size`` classes, flattened to a one-hot vector. ``sample`` draws as
  ``jax.random.categorical`` does: argmax over the class axis of
  ``logits + gumbel``. ``rsample`` is the straight-through sample, ``kl`` /
  ``balanced_kl`` the DreamerV2 balanced KL, all plain PyTorch.
  ``rsample_balanced_kl`` is what a training step calls: both at once, for
  the posterior's sample and its KL to the prior; on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward and backward are the kernels of
  ``csrc/plan_kl.cu``. Its noise is Gumbel noise (``gumbel=``) or uniforms
  (``uniform=``, or the generator's ``torch.rand`` draw) that the forward
  kernel turns into Gumbel noise itself, as ``gumbel_of_uniform`` does:
  from the draw to the sample and the KL, one launch.
* ``continuous`` (MCIL): a diagonal Normal, softplus std plus ``min_std``.
  ``sample`` / ``rsample`` are ``mean + std * eps`` on a standard-normal
  draw ``eps`` (``normal=``, or the generator's ``torch.randn``), the KL the
  closed form summed over the plan. All of it stays eager PyTorch, as the
  JAX package computes it in plain ``jnp``: a (B, 256) elementwise pass.

The noise comes from the caller's ``torch.Generator`` unless the caller
passes it (tests pass the noise JAX drew); ``PlanDistribution.noise_name``
says which keyword carries it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from hulc_tpu_torch import kernels


class DiscretePlanState(NamedTuple):
    """Unnormalized logits, flattened: (..., category_size * class_size)."""

    logit: torch.Tensor


class ContinuousPlanState(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor


PlanState = Union[DiscretePlanState, ContinuousPlanState]


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
    plan_features: int = 256
    min_std: float = 1e-4

    def __post_init__(self):
        if self.kind not in ("discrete", "continuous"):
            raise ValueError(f"invalid plan distribution kind {self.kind!r}")

    @property
    def plan_dim(self) -> int:
        return self.category_size * self.class_size if self.kind == "discrete" else self.plan_features

    @property
    def state_dim(self) -> int:
        """Output width of the state projection: the logits, or mean and raw std."""
        return self.category_size * self.class_size if self.kind == "discrete" else 2 * self.plan_features

    @property
    def noise_name(self) -> str:
        """The keyword (and the policies' noise key) of a plan draw's noise."""
        return "gumbel" if self.kind == "discrete" else "normal"

    def make_state(self, x: torch.Tensor) -> PlanState:
        """The net's (..., state_dim) output as a state: the logits, or the
        mean and ``softplus(raw) + min_std``."""
        if self.kind == "discrete":
            return DiscretePlanState(logit=x)
        mean, raw = x.chunk(2, dim=-1)
        return ContinuousPlanState(mean=mean.float(), std=F.softplus(raw.float()) + self.min_std)

    def _grid_logits(self, state: DiscretePlanState) -> torch.Tensor:
        s = state.logit.float()
        return s.reshape(s.shape[:-1] + (self.category_size, self.class_size))

    def _flat_one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        one_hot = F.one_hot(idx, self.class_size).float()
        return one_hot.reshape(one_hot.shape[:-2] + (self.plan_dim,))

    def _noise(self, state: PlanState, generator, gumbel, normal) -> torch.Tensor:
        """The draw's noise: the injected tensor of this kind's name, or the
        generator's draw (Gumbel of one ``torch.rand``, or ``torch.randn``)."""
        given, other = (gumbel, normal) if self.kind == "discrete" else (normal, gumbel)
        if other is not None:
            raise ValueError(f"a {self.kind} plan takes its noise as {self.noise_name}=")
        if given is not None:
            return given
        if self.kind == "discrete":
            logits = self._grid_logits(state)
            return gumbel_noise(logits.shape, generator, logits.device)
        return torch.randn(state.mean.shape, generator=generator, device=state.mean.device)

    def sample(
        self,
        state: PlanState,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Non-reparameterized sample, flattened to (..., plan_dim). gumbel:
        optional (..., category_size, class_size) noise (discrete); normal:
        optional (..., plan_features) standard-normal noise (continuous)."""
        eps = self._noise(state, generator, gumbel, normal)
        if self.kind == "discrete":
            return self._flat_one_hot(torch.argmax(eps + self._grid_logits(state), dim=-1))
        return (state.mean + state.std * eps).detach()

    def mode(self, state: PlanState) -> torch.Tensor:
        """Deterministic plan: the argmax one-hot (flattened), or the mean."""
        if self.kind == "discrete":
            return self._flat_one_hot(torch.argmax(self._grid_logits(state), dim=-1))
        return state.mean

    def rsample(
        self,
        state: PlanState,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Reparameterized sample, flattened: the straight-through
        ``(one_hot + p) - sg(p)``, or ``mean + std * eps``."""
        eps = self._noise(state, generator, gumbel, normal)
        if self.kind == "continuous":
            return state.mean + state.std * eps
        logits = self._grid_logits(state)
        one_hot = F.one_hot(torch.argmax(eps + logits, dim=-1), self.class_size).float()
        probs = torch.softmax(logits, dim=-1)
        st = one_hot + probs - probs.detach()
        return st.reshape(st.shape[:-2] + (self.plan_dim,))

    def kl(self, p: PlanState, q: PlanState) -> torch.Tensor:
        """KL(p || q) per batch element (summed over the plan), fp32."""
        if self.kind == "discrete":
            lp = torch.log_softmax(self._grid_logits(p), dim=-1)
            lq = torch.log_softmax(self._grid_logits(q), dim=-1)
            return (torch.exp(lp) * (lp - lq)).sum(dim=-1).sum(dim=-1)
        pm, ps, qm, qs = p.mean.float(), p.std.float(), q.mean.float(), q.std.float()
        per_dim = torch.log(qs / ps) + (ps**2 + (pm - qm) ** 2) / (2.0 * qs**2) - 0.5
        return per_dim.sum(dim=-1)

    @staticmethod
    def stop_gradient(state: PlanState) -> PlanState:
        return type(state)(*(t.detach() for t in state))

    def balanced_kl(
        self, posterior: PlanState, prior: PlanState, alpha: float, per_sample: bool = False
    ) -> torch.Tensor:
        """alpha * KL(sg[post] || prior) + (1 - alpha) * KL(post || sg[prior]);
        the mean over the batch unless ``per_sample``."""
        kl_lhs = self.kl(self.stop_gradient(posterior), prior)
        kl_rhs = self.kl(posterior, self.stop_gradient(prior))
        out = alpha * kl_lhs + (1.0 - alpha) * kl_rhs
        return out if per_sample else out.mean()

    def rsample_balanced_kl(
        self,
        posterior: PlanState,
        prior: PlanState,
        alpha: float,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        uniform: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
        use_kernels: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reparameterized sample of the posterior (B, plan_dim), per-sample
        balanced KL (B,)). A discrete plan's noise: ``gumbel`` (B,
        category_size, class_size) Gumbel noise, or ``uniform`` of that shape
        in [0, 1), or else one ``torch.rand`` draw of ``generator`` (the draw
        ``gumbel_noise`` makes); uniforms go through ``gumbel_of_uniform``. A
        continuous plan's: ``normal`` (B, plan_features), or the generator's
        ``torch.randn`` draw; it has no kernel. ``use_kernels=False`` runs the
        plain version on any device; it exists to hold the kernels against
        it on the card."""
        if self.kind == "continuous":
            if uniform is not None:
                raise ValueError("a continuous plan takes its noise as normal=")
            sample = self.rsample(posterior, generator=generator, gumbel=gumbel, normal=normal)
            return sample, self.balanced_kl(posterior, prior, alpha, per_sample=True)
        if normal is not None:
            raise ValueError("a discrete plan takes its noise as gumbel= or uniform=")
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
