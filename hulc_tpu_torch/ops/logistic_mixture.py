"""Discretized logistic mixture: NLL and sampling (port of
hulc_tpu/ops/logistic_mixture.py and decoders.py:52-61).

``sample_action`` picks one of K mixture components per action dimension
by Gumbel-max, inverts that component's logistic CDF, and appends the
gripper column picked by the gripper logits' argmax. It takes the two
uniforms it needs, ``u_mix`` (..., A, K) and ``u_inv`` (..., A), as inputs
with the map into (1e-5, 1 - 1e-5) that they still need:
``draw_raw_uniforms`` draws them from a ``torch.Generator`` and
``map_uniforms`` maps them as the JAX package draws them (tests pass
exactly the noise JAX drew instead, with the identity map). It is the
``hulc::sample_action`` op (``ops.library``): on a CUDA tensor the whole
action, from the raw draws on, is one launch of the hand-written kernel
``csrc/logistic_mixture.cu``; on a CPU tensor the plain version.

``logistic_mixture_log_prob`` / ``logistic_mixture_loss`` and
``cross_entropy_gripper`` are the JAX functions in plain PyTorch.
``mixture_nll`` is the training loss the decoder takes: per (b, s) frame,
the NLL summed over action dims plus ``gripper_alpha`` times the gripper
cross-entropy. On CUDA tensors it is a ``torch.autograd.Function`` whose
forward and backward are the kernels of ``csrc/logistic_mixture_loss.cu``:
when autograd will need the inputs' gradients, the forward kernel also
writes each frame's per-component derivatives, and the backward kernel
scales them by the incoming gradient (``mixture_nll_grad_plain`` is that
closed form in plain PyTorch). The action bounds come from a per-device
cache (``action_bounds``), so a call uploads nothing. On CPU tensors it is
the plain version, differentiated by autograd.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from hulc_tpu_torch import kernels
from hulc_tpu_torch.parallel import mesh

U_MIN, U_MAX = 1e-5, 1.0 - 1e-5
U_SPAN = U_MAX - U_MIN


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as jax.nn.softplus (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _bin_log_prob(log_scales, means, actions, act_min_bound, act_max_bound, num_classes, log_scale_min,
                  derivatives=False):
    """(..., A, K) log mass of each (..., A) action's bin under each
    component: the three ``where`` branches of the JAX function. With
    ``derivatives`` also its closed-form derivatives with respect to the
    mean and to the clamped log scale, each branch's own (no autograd)."""
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

    lower, upper, interior = actions < act_min + 1e-3, actions > act_max - 1e-3, cdf_delta > 1e-5
    log_probs = torch.where(
        lower,
        log_cdf_plus,
        torch.where(
            upper,
            log_one_minus_cdf_min,
            torch.where(
                interior,
                torch.log(torch.clamp_min(cdf_delta, 1e-12)),
                log_pdf_mid - math.log((num_classes - 1) / 2.0),
            ),
        ),
    )
    if not derivatives:
        return log_probs
    # each branch as a function of its argument u (plus_in, min_in or
    # mid_in): d/d mean = -f'(u) * inv_stdv, d/d log_scale = -f'(u) * u
    s_plus, s_min = torch.sigmoid(plus_in), torch.sigmoid(min_in)
    d_plus = s_plus * (1.0 - s_plus) / cdf_delta
    d_min = -s_min * (1.0 - s_min) / cdf_delta
    d_mid = 1.0 - 2.0 * torch.sigmoid(mid_in)

    def pick(at_lower, at_upper, at_interior, at_mid):
        return torch.where(lower, at_lower, torch.where(upper, at_upper, torch.where(interior, at_interior, at_mid)))

    d_mean = pick(-(1.0 - s_plus) * inv_stdv, s_min * inv_stdv, -(d_plus + d_min) * inv_stdv, -d_mid * inv_stdv)
    d_log_scale = pick(-(1.0 - s_plus) * plus_in, s_min * min_in, -(d_plus * plus_in + d_min * min_in),
                       -d_mid * mid_in - 1.0)
    return log_probs, d_mean, d_log_scale


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
    log_probs = _bin_log_prob(log_scales, means, actions, act_min_bound, act_max_bound, num_classes, log_scale_min)
    log_probs = log_probs + torch.log_softmax(logit_probs.float(), dim=-1)
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


def mixture_nll_grad_plain(
    logit_probs, log_scales, means, actions, gripper_logits, act_min_bound, act_max_bound,
    num_classes, log_scale_min, gripper_alpha, grad,
):
    """The gradients of ``sum(grad * mixture_nll(...))`` with respect to
    (logit_probs, log_scales, means, gripper_logits) in closed form, as the
    kernels compute them: per component, with pi the mixture softmax and w
    the weight in its dimension's logsumexp, d_logit = pi - w, d_mean =
    -w * d branch / d mean, d_log_scale = -w * d branch / d log_scale (zero
    where the clamp is active), and for the gripper alpha * (softmax -
    onehot); each frame's scaled by its ``grad``. The gripper's is None
    without gripper logits."""
    a = logit_probs.shape[-2]
    branch, d_mean, d_log_scale = _bin_log_prob(
        log_scales, means, actions[..., :a], act_min_bound, act_max_bound, num_classes, log_scale_min,
        derivatives=True,
    )
    log_pi = torch.log_softmax(logit_probs.float(), dim=-1)
    comp = branch + log_pi
    w = torch.exp(comp - torch.logsumexp(comp, dim=-1, keepdim=True))
    g = grad.float()[..., None, None]
    d_log_scale = torch.where(log_scales.float() < log_scale_min, 0.0, d_log_scale)
    d_grip = None
    if gripper_logits is not None:
        onehot = torch.nn.functional.one_hot((actions[..., a] > 0).long(), 2).float()
        d_grip = grad.float()[..., None] * (gripper_alpha * (torch.softmax(gripper_logits.float(), -1) - onehot))
    return g * (torch.exp(log_pi) - w), g * (-w * d_log_scale), g * (-w * d_mean), d_grip


@functools.cache
def action_bounds(
    act_min_bound: Tuple[float, ...], act_max_bound: Tuple[float, ...], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (A,) fp32 bounds on ``device``, made once for each set of bounds
    and device: a call of ``mixture_nll`` then copies nothing to the device
    (a copy from pageable host memory would wait for the stream to drain)."""
    return tuple(torch.tensor(b, dtype=torch.float32, device=device) for b in (act_min_bound, act_max_bound))


class _MixtureNLL(torch.autograd.Function):
    """The kernels of csrc/logistic_mixture_loss.cu: the forward, which with
    ``need_grad`` also writes the per-frame derivatives, and the backward,
    which scales them by the incoming gradient."""

    @staticmethod
    def forward(ctx, logit_probs, log_scales, means, gripper_logits, actions, act_min, act_max, consts):
        num_classes, log_scale_min, gripper_alpha, need_grad = consts
        *lead, a, k = logit_probs.shape
        out = torch.empty(lead, dtype=torch.float32, device=logit_probs.device)
        derivs = [None] * 4
        if need_grad:
            derivs = [torch.empty_like(logit_probs) for _ in range(3)]
            derivs.append(torch.empty_like(gripper_logits) if gripper_logits is not None else None)
        ptr = [None if t is None else t.data_ptr() for t in (gripper_logits, *derivs)]
        kernels.MIXTURE_NLL_FWD(
            logit_probs.device, logit_probs.data_ptr(), log_scales.data_ptr(), means.data_ptr(),
            actions.data_ptr(), ptr[0], act_min.data_ptr(), act_max.data_ptr(), out.data_ptr(), *ptr[1:],
            out.numel(), a, k, actions.shape[-1], num_classes, log_scale_min, gripper_alpha,
        )
        if need_grad:
            ctx.save_for_backward(*derivs)
        return out

    @staticmethod
    def backward(ctx, grad):
        derivs = ctx.saved_tensors
        grad = grad.float().contiguous()
        grads = [None if d is None else torch.empty_like(d) for d in derivs]
        a, k = derivs[0].shape[-2:]
        kernels.MIXTURE_NLL_BWD(
            grad.device, grad.data_ptr(), *(None if t is None else t.data_ptr() for t in (*derivs, *grads)),
            grad.numel(), a * k,
        )
        return (*grads, None, None, None, None)


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
    act_min, act_max = action_bounds(tuple(act_min_bound), tuple(act_max_bound), actions.device)
    if act_min.shape != (a,) or act_max.shape != (a,):
        raise ValueError(f"action bounds must have {a} entries")
    need_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (*params, gripper_logits)
    )
    consts = (int(num_classes), float(log_scale_min), float(gripper_alpha), need_grad)
    return _MixtureNLL.apply(*params, gripper_logits, actions, act_min, act_max, consts)


def draw_raw_uniforms(
    shape: Tuple[int, ...], generator: Optional[torch.Generator], device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two ``torch.rand`` draws in [0, 1) for logits of shape (..., A, K):
    (..., A, K) for the component pick, (..., A) for the inverse CDF."""
    def draw(s):
        return torch.rand(s, generator=generator, device=device)

    u_mix = mesh.draw_rows(draw, shape)
    u_inv = mesh.draw_rows(draw, shape[:-1])
    return u_mix, u_inv


def map_uniforms(u: torch.Tensor, lo: float = U_MIN, span: float = U_SPAN) -> torch.Tensor:
    """``lo + span * u``: a multiply, then an add, each rounded in fp32 (the
    sampler kernel computes the same); the identity map (0, 1) returns u."""
    return u if (lo, span) == (0.0, 1.0) else lo + span * u


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


def gripper_pick_plain(gripper_logits: torch.Tensor, closed: float, open_: float) -> torch.Tensor:
    """(..., 2) gripper logits -> (...) ``open_`` where argmax picks index 1,
    else ``closed``."""
    return torch.where(torch.argmax(gripper_logits, dim=-1) == 1, open_, closed)


def sample_action_plain(
    logit_probs, log_scales, means, u_mix, u_inv, gripper_logits=None, gripper_bounds=(-1.0, 1.0),
    uniform_map=(U_MIN, U_SPAN),
) -> torch.Tensor:
    """Plain PyTorch version of ``sample_action``: the uniforms mapped, the
    sample, then the gripper column."""
    actions = logistic_mixture_sample_plain(
        logit_probs, log_scales, means, *(map_uniforms(u, *uniform_map) for u in (u_mix, u_inv))
    )
    if gripper_logits is None:
        return actions
    gripper = gripper_pick_plain(gripper_logits, *gripper_bounds)
    return torch.cat([actions, gripper[..., None].to(actions.dtype)], dim=-1)


def sample_action(
    logit_probs: torch.Tensor,
    log_scales: torch.Tensor,
    means: torch.Tensor,
    u_mix: torch.Tensor,
    u_inv: torch.Tensor,
    gripper_logits: Optional[torch.Tensor] = None,
    gripper_bounds: Tuple[float, float] = (-1.0, 1.0),
    uniform_map: Tuple[float, float] = (U_MIN, U_SPAN),
) -> torch.Tensor:
    """(..., A, K) mixture parameters, uniforms ``u_mix`` (..., A, K) and
    ``u_inv`` (..., A) mapped by ``uniform_map`` = (lo, span) as lo + span *
    u, and optional (..., 2) gripper logits -> the (..., A [+ 1]) action: the
    sample of each dimension, then ``gripper_bounds`` = (closed, open) by the
    gripper logits' argmax. Raw ``torch.rand`` draws take the default map,
    uniforms already in (U_MIN, U_MAX) take (0, 1). The ``hulc::sample_action``
    op: on a CUDA tensor one launch of ``csrc/logistic_mixture.cu``; on a CPU
    tensor the plain version."""
    return torch.ops.hulc.sample_action(logit_probs, log_scales, means, u_mix, u_inv, gripper_logits,
                                        *map(float, gripper_bounds), *map(float, uniform_map))


def sample_action_kernel(
    logit_probs, log_scales, means, u_mix, u_inv, gripper_logits, gripper_bounds, uniform_map
) -> torch.Tensor:
    """``sample_action``'s kernel on CUDA tensors."""
    params = [t.float().contiguous() for t in (logit_probs, log_scales, means, u_mix)]
    u_inv = u_inv.float().contiguous()
    for name, t in zip(("logit_probs", "log_scales", "means", "u_mix"), params):
        kernels.require_cuda_tensor(name, t, torch.float32)
        if t.shape != logit_probs.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(logit_probs.shape)}")
    kernels.require_cuda_tensor("u_inv", u_inv, torch.float32)
    if u_inv.shape != logit_probs.shape[:-1]:
        raise ValueError(f"u_inv has shape {tuple(u_inv.shape)}, expected {tuple(logit_probs.shape[:-1])}")
    *lead, a, k = logit_probs.shape
    if k < 1:
        raise ValueError("the mixture needs at least one component")
    grip_ptr = None
    if gripper_logits is not None:
        gripper_logits = gripper_logits.float().contiguous()
        kernels.require_cuda_tensor("gripper_logits", gripper_logits, torch.float32)
        if gripper_logits.shape != (*lead, 2):
            raise ValueError(f"gripper_logits has shape {tuple(gripper_logits.shape)}, expected {(*lead, 2)}")
        grip_ptr = gripper_logits.data_ptr()
    out = torch.empty((*lead, a + (gripper_logits is not None)), dtype=torch.float32, device=logit_probs.device)
    kernels.LOGISTIC_MIXTURE_SAMPLE(
        logit_probs.device, *(t.data_ptr() for t in params), u_inv.data_ptr(), grip_ptr, out.data_ptr(),
        u_inv.numel(), a, k, *uniform_map, *gripper_bounds,
    )
    return out

