"""Logistic-mixture action sampling (port of hulc_tpu/ops/logistic_mixture.py).

``logistic_mixture_sample`` picks one of K mixture components per action
dimension by Gumbel-max and inverts that component's logistic CDF. It
takes the two uniforms it needs, ``u_mix`` (..., A, K) and ``u_inv``
(..., A), as inputs; ``draw_uniforms`` draws them from a
``torch.Generator`` in (1e-5, 1 - 1e-5), as the JAX package draws them
(tests pass exactly the noise JAX drew instead). On a CUDA tensor the
sample is the hand-written kernel ``csrc/logistic_mixture.cu``; on a CPU
tensor the plain version. The mixture NLL and its backward wait for the
training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hulc_tpu_torch import kernels

U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


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
