"""Discretized logistic mixture: NLL and sampling (port of
hulc_tpu/ops/logistic_mixture.py and decoders.py:52-61).

``logistic_mixture_sample`` picks one of K mixture components per action
dimension by Gumbel-max and inverts that component's logistic CDF. It
takes the two uniforms it needs, ``u_mix`` (..., A, K) and ``u_inv``
(..., A), as inputs; ``draw_uniforms`` draws them from a
``torch.Generator`` in (1e-5, 1 - 1e-5), as the JAX package draws them
(tests pass exactly the noise JAX drew instead). On a CUDA tensor the
sample is the hand-written kernel ``csrc/logistic_mixture.cu``; on a CPU
tensor the plain version.

``logistic_mixture_log_prob`` / ``logistic_mixture_loss`` and
``cross_entropy_gripper`` are the JAX functions in plain PyTorch.
``mixture_nll`` is the training loss the decoder takes: per (b, s) frame,
the NLL summed over action dims plus ``gripper_alpha`` times the gripper
cross-entropy. On CUDA tensors it is a ``torch.autograd.Function`` whose
forward and backward are the kernels of ``csrc/logistic_mixture_loss.cu``;
on CPU tensors it is the plain version, differentiated by autograd.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from hulc_tpu_torch import kernels

U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as jax.nn.softplus (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def logistic_mixture_log_prob(
    logit_probs: torch.Tensor,
    log_scales: torch.Tensor,
    means: torch.Tensor,
    actions: torch.Tensor,
    act_min_bound: Sequence[float],
    act_max_bound: Sequence[float],
    num_classes: int,
    log_scale_min: float = -7.0,
) -> torch.Tensor:
    """(..., A, K) mixture parameters and (..., A) actions -> (..., A)
    log-likelihood of each action's bin, mixture-reduced."""
    logit_probs = logit_probs.float()
    log_scales = torch.clamp_min(log_scales.float(), log_scale_min)
    actions = actions.float()[..., None]
    act_max = torch.as_tensor(act_max_bound, dtype=torch.float32, device=actions.device)[:, None]
    act_min = torch.as_tensor(act_min_bound, dtype=torch.float32, device=actions.device)[:, None]
    bin_half_width = ((act_max - act_min) / 2.0) / (num_classes - 1)

    centered = actions - means.float()
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + bin_half_width)
    min_in = inv_stdv * (centered - bin_half_width)
    log_cdf_plus = plus_in - _softplus(plus_in)
    log_one_minus_cdf_min = -_softplus(min_in)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * _softplus(mid_in)

    log_probs = torch.where(
        actions < act_min + 1e-3,
        log_cdf_plus,
        torch.where(
            actions > act_max - 1e-3,
            log_one_minus_cdf_min,
            torch.where(
                cdf_delta > 1e-5,
                torch.log(torch.clamp_min(cdf_delta, 1e-12)),
                log_pdf_mid - math.log((num_classes - 1) / 2.0),
            ),
        ),
    )
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


def logistic_mixture_loss(
    logit_probs, log_scales, means, actions, act_min_bound, act_max_bound, num_classes,
    log_scale_min: float = -7.0, per_sample: bool = False,
) -> torch.Tensor:
    """-mean over batch and time of the sum over dims; ``per_sample`` keeps
    the batch dim (B,)."""
    lp = logistic_mixture_log_prob(
        logit_probs, log_scales, means, actions, act_min_bound, act_max_bound, num_classes, log_scale_min
    )
    nll = -lp.sum(dim=-1)
    return nll.flatten(1).mean(dim=1) if per_sample else nll.mean()


def cross_entropy_gripper(gripper_logits: torch.Tensor, gripper_gt: torch.Tensor) -> torch.Tensor:
    """Per-frame 2-way CE; gt in {-1, 1} -> labels {0, 1}."""
    labels = (gripper_gt > 0).long()
    logp = torch.log_softmax(gripper_logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def mixture_nll_plain(
    logit_probs, log_scales, means, actions, gripper_logits, act_min_bound, act_max_bound,
    num_classes, log_scale_min, gripper_alpha,
) -> torch.Tensor:
    """Plain PyTorch version of ``mixture_nll``: per-frame (B, S) loss.
    ``actions`` holds the A continuous dims, then the gripper's when
    ``gripper_logits`` is given."""
    a = logit_probs.shape[-2]
    lp = logistic_mixture_log_prob(
        logit_probs, log_scales, means, actions[..., :a], act_min_bound, act_max_bound, num_classes,
        log_scale_min,
    )
    loss = -lp.sum(dim=-1)
    if gripper_logits is not None:
        loss = loss + gripper_alpha * cross_entropy_gripper(gripper_logits, actions[..., a])
    return loss


class _MixtureNLL(torch.autograd.Function):
    """The kernels of csrc/logistic_mixture_loss.cu, forward and backward."""

    @staticmethod
    def forward(ctx, logit_probs, log_scales, means, gripper_logits, actions, act_min, act_max, consts):
        num_classes, log_scale_min, gripper_alpha = consts
        *lead, a, k = logit_probs.shape
        rows = logit_probs.numel() // (a * k)
        out = torch.empty(lead, dtype=torch.float32, device=logit_probs.device)
        grip_ptr = gripper_logits.data_ptr() if gripper_logits is not None else None
        kernels.MIXTURE_NLL_FWD(
            logit_probs.device, logit_probs.data_ptr(), log_scales.data_ptr(), means.data_ptr(),
            actions.data_ptr(), grip_ptr, act_min.data_ptr(), act_max.data_ptr(), out.data_ptr(),
            rows, a, k, actions.shape[-1], num_classes, log_scale_min, gripper_alpha,
        )
        ctx.save_for_backward(logit_probs, log_scales, means, gripper_logits, actions, act_min, act_max)
        ctx.consts = consts
        return out

    @staticmethod
    def backward(ctx, grad):
        logit_probs, log_scales, means, gripper_logits, actions, act_min, act_max = ctx.saved_tensors
        num_classes, log_scale_min, gripper_alpha = ctx.consts
        a, k = logit_probs.shape[-2:]
        grad = grad.float().contiguous()
        d_lp, d_ls, d_mu = (torch.empty_like(logit_probs) for _ in range(3))
        d_grip = torch.empty_like(gripper_logits) if gripper_logits is not None else None
        kernels.MIXTURE_NLL_BWD(
            logit_probs.device, logit_probs.data_ptr(), log_scales.data_ptr(), means.data_ptr(),
            actions.data_ptr(), gripper_logits.data_ptr() if d_grip is not None else None,
            act_min.data_ptr(), act_max.data_ptr(), grad.data_ptr(), d_lp.data_ptr(), d_ls.data_ptr(),
            d_mu.data_ptr(), d_grip.data_ptr() if d_grip is not None else None,
            grad.numel(), a, k, actions.shape[-1], num_classes, log_scale_min, gripper_alpha,
        )
        return d_lp, d_ls, d_mu, d_grip, None, None, None, None


def mixture_nll(
    logit_probs: torch.Tensor,
    log_scales: torch.Tensor,
    means: torch.Tensor,
    actions: torch.Tensor,
    gripper_logits: Optional[torch.Tensor],
    act_min_bound: Sequence[float],
    act_max_bound: Sequence[float],
    num_classes: int,
    log_scale_min: float = -7.0,
    gripper_alpha: float = 1.0,
) -> torch.Tensor:
    """(..., A, K) mixture parameters, (..., A[+1]) actions and optional
    (..., 2) gripper logits -> (...) per-frame loss."""
    args = (logit_probs, log_scales, means, actions, gripper_logits, act_min_bound, act_max_bound,
            num_classes, log_scale_min, gripper_alpha)
    if logit_probs.device.type == "cpu":
        return mixture_nll_plain(*args)
    a = logit_probs.shape[-2]
    params = [t.float().contiguous() for t in (logit_probs, log_scales, means)]
    for name, t in zip(("logit_probs", "log_scales", "means"), params):
        kernels.require_cuda_tensor(name, t, torch.float32)
        if t.shape != logit_probs.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(logit_probs.shape)}")
    actions = actions.float().contiguous()
    kernels.require_cuda_tensor("actions", actions, torch.float32)
    want = a + (gripper_logits is not None)
    if actions.shape != logit_probs.shape[:-2] + (want,):
        raise ValueError(f"actions has shape {tuple(actions.shape)}, expected {tuple(logit_probs.shape[:-2]) + (want,)}")
    if gripper_logits is not None:
        gripper_logits = gripper_logits.float().contiguous()
        kernels.require_cuda_tensor("gripper_logits", gripper_logits, torch.float32)
        if gripper_logits.shape != logit_probs.shape[:-2] + (2,):
            raise ValueError(f"gripper_logits has shape {tuple(gripper_logits.shape)}")
    act_min = torch.as_tensor(act_min_bound, dtype=torch.float32, device=actions.device)
    act_max = torch.as_tensor(act_max_bound, dtype=torch.float32, device=actions.device)
    if act_min.shape != (a,) or act_max.shape != (a,):
        raise ValueError(f"action bounds must have {a} entries")
    consts = (int(num_classes), float(log_scale_min), float(gripper_alpha))
    return _MixtureNLL.apply(*params, gripper_logits, actions, act_min, act_max, consts)


def draw_uniforms(
    shape: Tuple[int, ...], generator: Optional[torch.Generator], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u_mix, u_inv)`` for logits of shape (..., A, K), in (U_MIN, U_MAX)."""
    u_mix = torch.rand(shape, generator=generator, device=device)
    u_inv = torch.rand(shape[:-1], generator=generator, device=device)
    return U_MIN + (U_MAX - U_MIN) * u_mix, U_MIN + (U_MAX - U_MIN) * u_inv


def logistic_mixture_sample_plain(
    logit_probs: torch.Tensor,
    log_scales: torch.Tensor,
    means: torch.Tensor,
    u_mix: torch.Tensor,
    u_inv: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the sampler, in fp32."""
    idx = torch.argmax(logit_probs.float() - torch.log(-torch.log(u_mix)), dim=-1, keepdim=True)
    sel_log_scales = torch.gather(log_scales.float(), -1, idx)[..., 0]
    sel_means = torch.gather(means.float(), -1, idx)[..., 0]
    return sel_means + torch.exp(sel_log_scales) * (torch.log(u_inv) - torch.log(1.0 - u_inv))


def logistic_mixture_sample(
    logit_probs: torch.Tensor,
    log_scales: torch.Tensor,
    means: torch.Tensor,
    u_mix: torch.Tensor,
    u_inv: torch.Tensor,
) -> torch.Tensor:
    """(..., A, K) mixture parameters -> (..., A) sampled actions."""
    if logit_probs.device.type == "cpu":
        return logistic_mixture_sample_plain(logit_probs, log_scales, means, u_mix, u_inv)
    params = [t.float().contiguous() for t in (logit_probs, log_scales, means, u_mix)]
    u_inv = u_inv.float().contiguous()
    for name, t in zip(("logit_probs", "log_scales", "means", "u_mix"), params):
        kernels.require_cuda_tensor(name, t, torch.float32)
        if t.shape != logit_probs.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(logit_probs.shape)}")
    kernels.require_cuda_tensor("u_inv", u_inv, torch.float32)
    if u_inv.shape != logit_probs.shape[:-1]:
        raise ValueError(f"u_inv has shape {tuple(u_inv.shape)}, expected {tuple(logit_probs.shape[:-1])}")
    out = torch.empty(logit_probs.shape[:-1], dtype=torch.float32, device=logit_probs.device)
    kernels.LOGISTIC_MIXTURE_SAMPLE(
        logit_probs.device, *(t.data_ptr() for t in params), u_inv.data_ptr(), out.data_ptr(),
        out.numel(), logit_probs.shape[-1],
    )
    return out
