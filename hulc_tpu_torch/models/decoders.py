"""Action decoders (port of hulc_tpu/models/decoders.py:30-300).

``LogisticPolicyDecoder``: an RNN (the relu cell, or the gru or lstm cell that
``config.apply_overrides`` selects; ``rnn_dropout`` between its layers in
train mode) with an explicit carry (lstm's a pair (h, c)) over
concat(plan, a slice of the perceptual embedding, latent goal; GCBC's
empty plan is left out of it;
its recurrence a hand-written kernel per layer on CUDA tensors, forward and
backward), three heads for the mixture's logits,
log scales (clamped at ``log_scale_min``) and means, and a two-way gripper
head. ``act`` samples one action per step through the mixture sampler,
which also picks the gripper by argmax (one hand-written kernel on CUDA
tensors, from the raw uniform draws to the action), and rotates the
action from the TCP frame back to the world frame. ``loss``
rotates the ground-truth actions into the TCP frame and takes the mixture
NLL plus ``gripper_alpha`` times the gripper cross-entropy
(``ops.logistic_mixture.mixture_nll``, a forward and a backward kernel on
CUDA tensors). ``loss_and_act`` is the validation pass: the teacher-forced
loss and the sampled window of actions from one forward (under
``torch.no_grad`` the loss kernel writes no derivatives). In bf16
(``dtype``) the RNN's input is cast to bf16 and its input projections run
in bf16; the recurrence, its output and the four heads are fp32, as in
the JAX package.

The ``mlp`` cell (``action_decoder.rnn_cell=mlp``) replaces the RNN by
three Linear layers of ``hidden_size`` (``rnn.{0,2,4}``, relu between them,
none after the last), applied to each frame alone: it has no recurrence
and its carry is an empty ``(0,)`` tensor, passed through unchanged
(``decoder_carry``).

``DeterministicPolicyDecoder`` (``kind="deterministic"``): the same RNN or
MLP and one head, ``tanh(action_fc(y))``, the action itself; the Huber
(or MSE, ``criterion``) loss. As the reference, ``loss`` (training) takes
the criterion in the world frame even with ``gripper_control``, while
``loss_and_act`` (validation) takes it in the TCP frame and returns the
actions in the world frame. It draws no noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from hulc_tpu_torch.config import ActionDecoderConfig
from hulc_tpu_torch.models.layers import MLP, Carry, ScanRNN
from hulc_tpu_torch.ops.frame_transforms import tcp_to_world_frame, world_to_tcp_frame
from hulc_tpu_torch.ops.logistic_mixture import (
    U_MIN,
    U_SPAN,
    cross_entropy_gripper,
    draw_raw_uniforms,
    mixture_nll,
    mixture_nll_plain,
    sample_action,
    sample_action_plain,
)


class DecoderOutputs(NamedTuple):
    logit_probs: torch.Tensor  # (B, S, A, K)
    log_scales: torch.Tensor  # (B, S, A, K)
    means: torch.Tensor  # (B, S, A, K)
    gripper_logits: Optional[torch.Tensor]  # (B, S, 2) when discrete_gripper
    carry: Carry  # (num_layers, B, H), lstm's pair (h, c) of that shape, or the mlp cell's (0,)


def _cross_entropy_gripper(
    gripper_logits: torch.Tensor, gripper_gt: torch.Tensor, per_sample: bool = False
) -> torch.Tensor:
    """2-way CE on the discrete gripper channel, mean over all frames, or over
    all but the batch dim with ``per_sample``."""
    nll = cross_entropy_gripper(gripper_logits, gripper_gt)
    return nll.flatten(1).mean(dim=1) if per_sample else nll.mean()


def decoder_carry(cfg: ActionDecoderConfig, batch_size: int, device=None) -> Carry:
    """The decoder's zero carry for closed-loop inference: (num_layers, B,
    H), lstm's pair (h, c) of that shape, or the ``mlp`` cell's empty
    ``(0,)`` tensor (JAX's ``decoder_carry``)."""
    if cfg.rnn_cell == "mlp":
        return torch.zeros((0,), device=device)
    h = torch.zeros(cfg.num_layers, batch_size, cfg.hidden_size, device=device)
    return (h, torch.zeros_like(h)) if cfg.rnn_cell == "lstm" else h


class _RecurrentTrunk(nn.Module):
    """The decoders' shared trunk: the input concatenation and the RNN (or
    the ``mlp`` cell's three Linear layers) under ``rnn``."""

    def __init__(self, cfg: ActionDecoderConfig, use_kernels: bool, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.dtype = dtype
        emb = cfg.perceptual_features
        if cfg.perceptual_emb_slice is not None:
            emb = cfg.perceptual_emb_slice[1] - cfg.perceptual_emb_slice[0]
        in_features = cfg.plan_features + emb + cfg.latent_goal_features
        if cfg.rnn_cell == "mlp":
            self.rnn = MLP(in_features, [cfg.hidden_size] * 3, dtype=dtype)
        else:
            self.rnn = ScanRNN(in_features, cfg.hidden_size, cfg.num_layers, cfg.rnn_cell, use_kernels, dtype,
                               cfg.rnn_dropout)

    def _trunk(
        self, latent_plan: torch.Tensor, perceptual_emb: torch.Tensor, latent_goal: torch.Tensor,
        carry: Optional[Carry],
    ) -> Tuple[torch.Tensor, Optional[Carry]]:
        """(y (B, S, H) fp32, the new carry); the mlp cell passes the carry through."""
        c = self.cfg
        if c.perceptual_emb_slice is not None:
            perceptual_emb = perceptual_emb[..., c.perceptual_emb_slice[0] : c.perceptual_emb_slice[1]]
        b, s, _ = perceptual_emb.shape
        parts = []
        if latent_plan.shape[-1] > 0:  # GCBC's plan is empty
            parts.append(latent_plan[:, None].expand(b, s, latent_plan.shape[-1]))
        parts.append(perceptual_emb)
        parts.append(latent_goal[:, None].expand(b, s, latent_goal.shape[-1]))
        x = torch.cat([p.to(self.dtype) for p in parts], dim=-1)
        if c.rnn_cell == "mlp":
            return self.rnn(x).float(), carry
        return self.rnn(x, carry)


class LogisticPolicyDecoder(_RecurrentTrunk):
    """RNN + discretized logistic-mixture head (+ discrete gripper head).

    ``use_kernels=False`` runs the RNN's recurrence and the sampler as
    their plain versions on any device; it exists to hold the kernels
    against them on the card.
    """

    def __init__(self, cfg: ActionDecoderConfig, use_kernels: bool = True, dtype: torch.dtype = torch.float32):
        if cfg.kind != "logistic":
            raise ValueError(f"LogisticPolicyDecoder takes kind 'logistic', not {cfg.kind!r}")
        super().__init__(cfg, use_kernels, dtype)
        a = self.cont_dims
        self.mean_fc = nn.Linear(cfg.hidden_size, a * cfg.n_mixtures)
        self.log_scale_fc = nn.Linear(cfg.hidden_size, a * cfg.n_mixtures)
        self.prob_fc = nn.Linear(cfg.hidden_size, a * cfg.n_mixtures)
        if cfg.discrete_gripper:
            self.gripper_fc = nn.Linear(cfg.hidden_size, 2)

    @property
    def cont_dims(self) -> int:
        """Continuous action dims (the gripper is discrete if configured)."""
        return self.cfg.out_features - 1 if self.cfg.discrete_gripper else self.cfg.out_features

    def forward(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        carry: Optional[Carry] = None,
    ) -> DecoderOutputs:
        c = self.cfg
        y, new_carry = self._trunk(latent_plan, perceptual_emb, latent_goal, carry)
        b, s = y.shape[:2]
        a, k = self.cont_dims, c.n_mixtures
        logit_probs = self.prob_fc(y).reshape(b, s, a, k)
        means = self.mean_fc(y).reshape(b, s, a, k)
        log_scales = torch.clamp_min(self.log_scale_fc(y).reshape(b, s, a, k), c.log_scale_min)
        gripper_logits = self.gripper_fc(y) if c.discrete_gripper else None
        return DecoderOutputs(logit_probs, log_scales, means, gripper_logits, new_carry)

    def _bounds(self):
        c = self.cfg
        if c.discrete_gripper:
            return c.act_min_bound[:-1], c.act_max_bound[:-1]
        return c.act_min_bound, c.act_max_bound

    def _loss_from_outputs(
        self, out: DecoderOutputs, actions: torch.Tensor, per_sample: bool = False
    ) -> torch.Tensor:
        """Mixture NLL (+ gripper_alpha x gripper CE) of TCP-frame ``actions``:
        the mean over frames, or (B,) means over time with ``per_sample``."""
        c = self.cfg
        amin, amax = self._bounds()
        nll = mixture_nll if self.use_kernels else mixture_nll_plain
        per_frame = nll(
            out.logit_probs, out.log_scales, out.means, actions,
            out.gripper_logits if c.discrete_gripper else None,
            amin, amax, c.num_classes, c.log_scale_min, c.gripper_alpha,
        )
        return per_frame.flatten(1).mean(dim=1) if per_sample else per_frame.mean()

    def loss(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        per_sample: bool = False,
    ) -> torch.Tensor:
        """Teacher-forced training loss over a window, from a zero carry."""
        out = self(latent_plan, perceptual_emb, latent_goal)
        if self.cfg.gripper_control:
            actions = world_to_tcp_frame(actions, robot_obs)
        return self._loss_from_outputs(out, actions, per_sample=per_sample)

    def loss_and_act(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(teacher-forced loss, sampled (B, S, 7) actions) over a window
        from a zero carry; with ``gripper_control`` the loss is taken in the
        TCP frame and the actions are returned in the world frame."""
        out = self(latent_plan, perceptual_emb, latent_goal)
        pred = self._sample_from_outputs(out, generator, u_mix, u_inv)
        if self.cfg.gripper_control:
            loss = self._loss_from_outputs(out, world_to_tcp_frame(actions, robot_obs))
            return loss, tcp_to_world_frame(pred, robot_obs)
        return self._loss_from_outputs(out, actions), pred

    def _sample_from_outputs(
        self,
        out: DecoderOutputs,
        generator: Optional[torch.Generator],
        u_mix: Optional[torch.Tensor],
        u_inv: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """The (B, S, A [+ 1]) TCP-frame action. Injected ``u_mix`` / ``u_inv``
        are uniforms in (U_MIN, U_MAX); without them the generator's raw draws
        are mapped there inside the sampler."""
        c = self.cfg
        if (u_mix is None) != (u_inv is None):
            raise ValueError("pass both u_mix and u_inv, or neither")
        uniform_map = (0.0, 1.0)
        if u_mix is None:
            u_mix, u_inv = draw_raw_uniforms(tuple(out.logit_probs.shape), generator, out.logit_probs.device)
            uniform_map = (U_MIN, U_SPAN)
        sample = sample_action if self.use_kernels else sample_action_plain
        return sample(
            out.logit_probs, out.log_scales, out.means, u_mix, u_inv,
            out.gripper_logits if c.discrete_gripper else None, (c.act_min_bound[-1], c.act_max_bound[-1]),
            uniform_map,
        )

    def act(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        robot_obs: torch.Tensor,
        carry: Carry,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Carry]:
        """One closed-loop step: (B, S, 7) world-frame actions and the new carry."""
        out = self(latent_plan, perceptual_emb, latent_goal, carry)
        pred = self._sample_from_outputs(out, generator, u_mix, u_inv)
        if self.cfg.gripper_control:
            pred = tcp_to_world_frame(pred, robot_obs)
        return pred, out.carry


class DeterministicPolicyDecoder(_RecurrentTrunk):
    """RNN (or the mlp cell) + a tanh action head, the Huber or MSE loss."""

    def __init__(self, cfg: ActionDecoderConfig, use_kernels: bool = True, dtype: torch.dtype = torch.float32):
        if cfg.kind != "deterministic":
            raise ValueError(f"DeterministicPolicyDecoder takes kind 'deterministic', not {cfg.kind!r}")
        if cfg.criterion not in ("huber", "mse"):
            raise ValueError(f"unknown criterion {cfg.criterion!r}; have 'huber' and 'mse'")
        super().__init__(cfg, use_kernels, dtype)
        self.action_fc = nn.Linear(cfg.hidden_size, cfg.out_features)

    def forward(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        carry: Optional[Carry] = None,
    ) -> Tuple[torch.Tensor, Optional[Carry]]:
        """(B, S, out_features) actions in (-1, 1), and the new carry."""
        y, new_carry = self._trunk(latent_plan, perceptual_emb, latent_goal, carry)
        return torch.tanh(self.action_fc(y)), new_carry

    def _criterion(self, pred: torch.Tensor, target: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
        diff = pred.float() - target.float()
        if self.cfg.criterion == "huber":
            absd = diff.abs()
            per_el = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5)
        else:
            per_el = diff.square()
        return per_el.flatten(1).mean(dim=1) if per_sample else per_el.mean()

    def loss(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        per_sample: bool = False,
    ) -> torch.Tensor:
        """The training loss over a window from a zero carry: the criterion
        in the world frame, whatever ``gripper_control`` says (the
        reference discards its TCP-frame criterion here)."""
        pred, _ = self(latent_plan, perceptual_emb, latent_goal)
        return self._criterion(pred, actions, per_sample=per_sample)

    def loss_and_act(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, (B, S, 7) actions) over a window from a zero carry; with
        ``gripper_control`` the loss in the TCP frame, the actions in the
        world frame. It draws nothing: ``generator`` is not used."""
        _refuse_noise(u_mix, u_inv)
        pred, _ = self(latent_plan, perceptual_emb, latent_goal)
        if self.cfg.gripper_control:
            loss = self._criterion(pred, world_to_tcp_frame(actions, robot_obs))
            return loss, tcp_to_world_frame(pred, robot_obs)
        return self._criterion(pred, actions), pred

    def act(
        self,
        latent_plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        robot_obs: torch.Tensor,
        carry: Carry,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Carry]:
        """One closed-loop step: (B, S, 7) world-frame actions and the new carry."""
        _refuse_noise(u_mix, u_inv)
        pred, new_carry = self(latent_plan, perceptual_emb, latent_goal, carry)
        if self.cfg.gripper_control:
            pred = tcp_to_world_frame(pred, robot_obs)
        return pred, new_carry


def _refuse_noise(u_mix, u_inv) -> None:
    if u_mix is not None or u_inv is not None:
        raise ValueError("the deterministic decoder draws no noise: pass no u_mix / u_inv")


def make_action_decoder(cfg: ActionDecoderConfig, use_kernels: bool = True, dtype: torch.dtype = torch.float32
                        ) -> Union[LogisticPolicyDecoder, DeterministicPolicyDecoder]:
    if cfg.kind == "logistic":
        return LogisticPolicyDecoder(cfg, use_kernels, dtype)
    if cfg.kind == "deterministic":
        return DeterministicPolicyDecoder(cfg, use_kernels, dtype)
    raise ValueError(f"unknown action decoder kind {cfg.kind!r}")
