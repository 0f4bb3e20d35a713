"""HULC model (port of hulc_tpu/models/hulc.py:44-136, 138-556, 593-662).

``HulcModel`` holds the reference's modules under its state_dict names
(``perceptual_encoder``, ``plan_proposal``, ``plan_recognition``,
``visual_goal``, ``language_goal``, ``action_decoder``, ``proj_vis_lang``,
``logit_scale``).

* Inference: ``encode``, ``encode_visual_goal``, ``encode_language_goal``,
  ``propose_plan`` and ``decoder_act``; closed-loop state (plan, goal,
  decoder carry) is passed in and out explicitly.
* Training: ``train_losses`` over a ``{"vis": B, "lang": B}`` batch (a pass
  per modality) or over a loader-fused ``{"fused": 2B}`` batch (one pass,
  ``_fused_train_losses``), with every loss key the JAX package returns.
  The plan's noise (a discrete plan's Gumbel noise, a continuous plan's
  standard-normal draw) comes from ``generator`` unless passed as
  ``gumbel`` / ``normal`` (a tensor for the fused pass, a dict by scope
  otherwise), and dropout draws from the generator
  ``layers.set_dropout_generator`` gave it.
* Validation: ``val_metrics`` over a ``{"vis", "lang"}`` batch, in eval
  mode (``lmp_val``: the action loss, MAEs and gripper success rate of a
  window decoded with the proposal's and with the recognition's plan,
  each drawn by ``PlanDistribution.sample``, and the KL scaled by
  the passed beta), with the JAX package's metric names. The plan and
  action noise come from ``generator`` unless passed as ``noise[scope]``
  (``VAL_NOISE_KEYS``).

The plan recognition is the transformer (``hulc``) or the BiRNN, and the
plan discrete or continuous (``mcil``). ``cfg.compute_dtype`` is float32 or
bfloat16: in bf16 the parameters stay fp32 and each module computes as its
JAX counterpart with ``dtype=bfloat16`` (``models.layers``); the losses,
the KL and the metrics come from fp32 heads or are cast to fp32, as JAX's.
Images arrive preprocessed, (B, S, C, H, W) fp32 or in the compute dtype,
and depth frames (B, S, H, W) fp32 (``training.preprocess``);
training and validation encode both (``hulc_depth``). The JAX package's
policies feed no depth, so the port's refuse a depth config
(``evaluation.policy.refuse_unserved``, which also refuses a CLIP camera
and a tactile tower, as the JAX package's policies cannot serve them;
training and validation encode the tactile frames after every camera).

GCBC (``model_kind="gcbc"``) decodes an empty (B, 0) plan: it has no plan
proposal (JAX's init never calls one, so it has no parameters), draws no
plan noise and takes no KL; the recognition network still runs, for
``seq_feat``. Its validation (``gcbc_val``) decodes once, with the
``*_pp`` noise, and reports the same values under ``*_pp`` and ``*_pr``.
The auxiliary losses on the language half: CLIP (``lang_clip_loss``),
BC-Z (``lang_pred_loss``, the language embedding regressed from
``seq_feat``) and MIA (``lang_contrastive_loss``, the discriminator's
binary cross-entropy on matched pairs and on pairs whose language is
rolled by one row); with ``state_recons`` the proprio regressed from the
visual features (``proprio_loss``). Each enters ``total_loss`` scaled by
its beta. Under a process group of more than one rank the CLIP, BC-Z and
MIA losses see every rank's rows (``parallel.mesh.gather_rows``), so MIA's
roll crosses ranks as it crosses the one-device batch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.models.aux_heads import BCZLangDecoder, MIALangDiscriminator, ProjVisLang
from hulc_tpu_torch.models.decoders import decoder_carry, make_action_decoder
from hulc_tpu_torch.models.goal_encoders import GoalEncoder, make_language_goal_encoder
from hulc_tpu_torch.models.layers import Carry, MultiheadSelfAttention, ScanBiRNN, ScanRNN
from hulc_tpu_torch.models.perceptual import ConcatEncoders
from hulc_tpu_torch.models.plan_nets import PlanProposalNetwork, make_plan_distribution, make_plan_recognition
from hulc_tpu_torch.models.vision import SpatialSoftmax
from hulc_tpu_torch.ops.plan_distributions import PlanState
from hulc_tpu_torch.parallel import mesh


class ModalityBatch(NamedTuple):
    """One modality's training batch (the JAX package's schema)."""

    rgb_static: Optional[torch.Tensor]  # (B, S, H, W, 3) u8 raw, (B, S, 3, H, W) fp32 preprocessed
    rgb_gripper: Optional[torch.Tensor]
    robot_obs: torch.Tensor  # (B, S, n_state) normalized proprio
    actions: torch.Tensor  # (B, S, 7)
    state_info_robot_obs: torch.Tensor  # (B, S, 15) unnormalized (TCP frame math)
    lang: Optional[torch.Tensor] = None  # (B, 384)
    use_for_aux_lang_loss: Optional[torch.Tensor] = None  # (B,) bool
    idx: Optional[torch.Tensor] = None  # (B,)
    depth_static: Optional[torch.Tensor] = None
    depth_gripper: Optional[torch.Tensor] = None
    rgb_tactile: Optional[torch.Tensor] = None

    # Fields that describe the language half only when [vis; lang] are
    # fused into one 2B batch; every other field is per-frame data.
    LANG_ONLY_FIELDS = ("lang", "use_for_aux_lang_loss", "idx")

    def rgb_obs(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in ("rgb_static", "rgb_gripper", "rgb_tactile")
                if getattr(self, k) is not None}

    def depth_obs(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in ("depth_static", "depth_gripper") if getattr(self, k) is not None}


def fuse_modalities(vis: ModalityBatch, lang: ModalityBatch) -> ModalityBatch:
    """[vis; lang] row-stacked into one 2B batch; the language-only fields
    come from ``lang``."""

    def cat(f):
        a, c = getattr(vis, f), getattr(lang, f)
        return torch.cat([a, c], dim=0) if a is not None and c is not None else None

    return ModalityBatch(**{
        f: getattr(lang, f) if f in ModalityBatch.LANG_ONLY_FIELDS else cat(f) for f in ModalityBatch._fields
    })


def masked_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Symmetric CLIP loss over the masked subset, with static shapes:
    masked columns get a -1e9 logit, masked rows leave the mean; an
    all-false mask gives 0. With a process group of more than one rank the
    rows (features and mask) are every rank's, gathered in rank order
    (``parallel.mesh.gather_rows``): each rank computes the whole batch's
    loss, and the gather's backward sums the ranks' gradients of its rows."""
    img = mesh.gather_rows(image_features.float())
    txt = mesh.gather_rows(text_features.float())
    if mask is not None:
        mask = mesh.gather_rows(mask.bool())
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    logits = logit_scale * img @ txt.T
    b = logits.shape[0]
    mask = torch.ones(b, dtype=torch.bool, device=logits.device) if mask is None else mask.bool()
    logits_i = torch.where(mask[None, :], logits, -1e9)  # a Python scalar: no host-to-device copy
    logits_t = torch.where(mask[None, :], logits.T, -1e9)
    logp_i = torch.diagonal(torch.log_softmax(logits_i, dim=-1))
    logp_t = torch.diagonal(torch.log_softmax(logits_t, dim=-1))
    count = mask.sum().clamp_min(1)
    zero = torch.zeros((), device=logits.device)
    loss_i = -torch.where(mask, logp_i, zero).sum() / count
    loss_t = -torch.where(mask, logp_t, zero).sum() / count
    return torch.where(mask.any(), (loss_i + loss_t) / 2.0, zero)


def masked_mia_loss(
    discriminator: nn.Module, image_features: torch.Tensor, text_features: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """MIA's binary cross-entropy of ``discriminator``'s match logits: label
    1 on the matched pairs, label 0 on each row's image features with the
    previous row's text features (rolled by one row), over the valid pairs
    (``mask`` and ``mask & roll(mask)``); 0 where the mask is all false.
    With more than one rank the rows are every rank's (``gather_rows``), so
    the roll crosses ranks as it crosses the one-device batch."""
    img, txt = mesh.gather_rows(image_features), mesh.gather_rows(text_features)
    pred_pos = discriminator(img, txt)[..., 0]
    pred_neg = discriminator(img, torch.roll(txt, 1, dims=0))[..., 0]
    mask = (torch.ones(pred_pos.shape, dtype=torch.bool, device=pred_pos.device) if mask is None
            else mesh.gather_rows(mask.bool()))
    neg_mask = mask & torch.roll(mask, 1, dims=0)

    def bce(logits, label):
        return nn.functional.softplus(logits) - logits * label

    losses = torch.cat([bce(pred_pos, 1.0) * mask, bce(pred_neg, 0.0) * neg_mask])
    count = (mask.sum() + neg_mask.sum()).clamp_min(1)
    return torch.where(mask.any(), losses.sum() / count, torch.zeros((), device=losses.device))


def masked_bc_z_loss(lang_pred: torch.Tensor, gt_lang: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Cosine distance of the predicted to the true language embedding,
    the mean over the masked rows (all rows without a mask; 0 where the
    mask is all false), fp32. With more than one rank, over every rank's
    rows (``gather_rows``)."""
    pred, gt = mesh.gather_rows(lang_pred.float()), mesh.gather_rows(gt_lang.float())
    cos = (pred * gt).sum(-1) / (torch.linalg.vector_norm(pred, dim=-1) * torch.linalg.vector_norm(gt, dim=-1) + 1e-8)
    dist = 1.0 - cos
    if mask is None:
        return dist.mean()
    mask = mesh.gather_rows(mask.bool())
    zero = torch.zeros((), device=dist.device)
    return torch.where(mask.any(), torch.where(mask, dist, zero).sum() / mask.sum().clamp_min(1), zero)


# the noise of one modality's validation pass, as lmp_val takes it injected:
# each plan's (B, category_size, class_size) Gumbel noise (a discrete plan)
# or (B, plan_features) standard-normal draw (a continuous plan) and each
# decoded window's (B, S, A, K) / (B, S, A) mixture uniforms in (U_MIN, U_MAX)
VAL_NOISE_KEYS = (
    "gumbel_pp", "normal_pp", "u_mix_pp", "u_inv_pp", "gumbel_pr", "normal_pr", "u_mix_pr", "u_inv_pr",
)

LOSS_KEYS = (
    "kl_loss", "action_loss", "total_loss", "proprio_loss", "lang_pred_loss",
    "lang_contrastive_loss", "lang_clip_loss",
)


class HulcModel(nn.Module):
    """The model. ``use_kernels=False`` runs every hand-written kernel's
    plain version instead, on any device; it exists to hold the kernels
    against their plain versions on the card."""

    def __init__(self, cfg: HulcConfig, use_kernels: bool = True):
        super().__init__()
        if cfg.model_kind not in ("hulc", "gcbc"):
            raise ValueError(f"unknown model_kind {cfg.model_kind!r}; have 'hulc' and 'gcbc'")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is neither 'float32' nor 'bfloat16'")
        pe = cfg.perceptual_encoder
        if cfg.state_recons and not (pe.use_state_decoder and pe.proprio is not None):
            raise ValueError("state_recons needs perceptual_encoder.use_state_decoder and a proprio input: the "
                             "state decoder regresses the proprio")
        self.cfg = cfg
        self.use_kernels = use_kernels
        dtype = cfg.dtype
        self.perceptual_encoder = ConcatEncoders(pe, use_kernels, dtype, cfg.state_recons)
        self.dist = make_plan_distribution(cfg.distribution)
        # GCBC never consults a proposal: JAX's init creates none
        self.plan_proposal = (
            None if self.gcbc else PlanProposalNetwork(cfg.plan_proposal, self.dist, dtype)
        )
        self.plan_recognition = make_plan_recognition(cfg.plan_recognition, self.dist, use_kernels, dtype)
        self.visual_goal = GoalEncoder(cfg.visual_goal, dtype=dtype)
        self.language_goal = (
            make_language_goal_encoder(cfg.language_goal, dtype) if cfg.language_goal else None
        )
        self.action_decoder = make_action_decoder(cfg.action_decoder, use_kernels, dtype)
        pr = cfg.plan_recognition
        seq_feat = pr.fc_hidden_size if pr.kind == "transformer" else 2 * pr.birnn_hidden_size
        if cfg.use_clip_auxiliary_loss or cfg.use_mia_auxiliary_loss:
            self.proj_vis_lang = ProjVisLang(
                seq_feat, cfg.visual_goal.latent_goal_features, cfg.proj_vis_lang_dim, dtype,
            )
        if cfg.use_clip_auxiliary_loss:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        if cfg.use_bc_z_auxiliary_loss:
            self.bc_z_lang_decoder = BCZLangDecoder(seq_feat, cfg.lang_dim, dtype)
        if cfg.use_mia_auxiliary_loss:
            self.mia_lang_discriminator = MIALangDiscriminator(2 * cfg.proj_vis_lang_dim, dtype=dtype)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def encode(
        self,
        rgb_obs: Dict[str, torch.Tensor],
        robot_obs: Optional[torch.Tensor] = None,
        depth_obs: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.perceptual_encoder(rgb_obs, robot_obs, depth_obs)

    def encode_visual_goal(self, last_emb: torch.Tensor) -> torch.Tensor:
        return self.visual_goal(last_emb)

    def encode_language_goal(self, lang: torch.Tensor) -> torch.Tensor:
        return self.language_goal(lang)

    @property
    def gcbc(self) -> bool:
        return self.cfg.model_kind == "gcbc"

    def empty_plan(self, batch: int) -> torch.Tensor:
        """GCBC's (B, 0) plan."""
        return torch.zeros((batch, 0), device=self.device)

    def propose_plan(
        self,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample a plan from the proposal prior; gumbel (B, category_size,
        class_size) or normal (B, plan_features) is optional noise, by the
        plan's kind. GCBC returns its empty plan and draws nothing."""
        if self.gcbc:
            _refuse_plan_noise(gumbel, normal)
            return self.empty_plan(perceptual_emb.shape[0])
        state = self.plan_proposal(perceptual_emb[:, 0], latent_goal)
        return self.dist.sample(state, generator=generator, gumbel=gumbel, normal=normal)

    def decoder_act(
        self,
        plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        robot_obs: torch.Tensor,
        carry: Carry,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Carry]:
        """One decoder step with the carry, a tensor or lstm's pair (h, c)."""
        return self.action_decoder.act(
            plan, perceptual_emb, latent_goal, robot_obs, carry,
            generator=generator, u_mix=u_mix, u_inv=u_inv,
        )

    def init_decoder_carry(self, batch_size: int) -> Carry:
        """The decoder's zero carry for closed-loop inference: (num_layers,
        B, H), lstm's pair (h, c) of that shape, or the mlp cell's (0,)
        (JAX's ``decoder_carry``)."""
        return decoder_carry(self.cfg.action_decoder, batch_size, self.device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def frozen_parameters(self) -> list:
        """The frozen backbones' parameters (CLIP, tactile): they take no
        gradient here; JAX's ``stop_gradient`` gives them zeros, which its
        optimizer steps (``Trainer.train_step`` supplies the zeros)."""
        return [p for m in self.modules() if m is not self and hasattr(m, "frozen_parameters")
                for p in m.frozen_parameters()]

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _plan_and_kl(
        self, pp_state: PlanState, pr_state: PlanState, generator: Optional[torch.Generator],
        gumbel: Optional[torch.Tensor], normal: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The posterior's reparameterized plan and the per-sample balanced KL."""
        return self.dist.rsample_balanced_kl(
            pr_state, pp_state, self.cfg.loss.kl_balancing_mix,
            generator=generator, gumbel=gumbel, normal=normal, use_kernels=self.use_kernels,
        )

    def lmp_train(
        self,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Posterior plan -> action loss and the (unscaled) balanced KL."""
        pp_state = self.plan_proposal(perceptual_emb[:, 0], latent_goal)
        pr_state, seq_feat = self.plan_recognition(perceptual_emb)
        sampled_plan, kl_ps = self._plan_and_kl(pp_state, pr_state, generator, gumbel, normal)
        action_loss = self.action_decoder.loss(sampled_plan, perceptual_emb, latent_goal, actions, robot_obs)
        return {
            "action_loss": action_loss,
            "kl_loss": kl_ps.mean(),
            "pp_state": pp_state,
            "pr_state": pr_state,
            "seq_feat": seq_feat,
        }

    def lmp_val(
        self,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        kl_beta: Optional[float] = None,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        """Validation pass: decode the window with the proposal's and with the
        recognition's plan. The KL is scaled by ``kl_beta`` (the annealed
        beta), or by the config's when it is None. ``noise`` holds
        ``VAL_NOISE_KEYS``; without it each draw comes from ``generator``."""
        noise = {} if noise is None else noise
        if not set(noise) <= set(VAL_NOISE_KEYS):
            raise ValueError(f"unknown validation noise {sorted(set(noise) - set(VAL_NOISE_KEYS))}")
        ad = self.action_decoder

        noise = {k: mesh.local_rows(v) for k, v in noise.items()}

        def decode(plan, tag):
            return ad.loss_and_act(
                plan, perceptual_emb, latent_goal, actions, robot_obs, generator=generator,
                u_mix=noise.get(f"u_mix_{tag}"), u_inv=noise.get(f"u_inv_{tag}"),
            )

        def sample(state, tag):
            return self.dist.sample(state, generator=generator, gumbel=noise.get(f"gumbel_{tag}"),
                                    normal=noise.get(f"normal_{tag}"))

        pp_state = self.plan_proposal(perceptual_emb[:, 0], latent_goal)
        sampled_plan_pp = sample(pp_state, "pp")
        action_loss_pp, sample_act_pp = decode(sampled_plan_pp, "pp")
        pr_state, seq_feat = self.plan_recognition(perceptual_emb)
        sampled_plan_pr = sample(pr_state, "pr")
        action_loss_pr, sample_act_pr = decode(sampled_plan_pr, "pr")
        kl_loss = self.dist.balanced_kl(pr_state, pp_state, self.cfg.loss.kl_balancing_mix)

        def mae(sample_act):
            return (sample_act[..., :-1] - actions[..., :-1]).abs().mean(dim=1)  # (B, 6)

        def gripper_sr(sample_act):
            pred = torch.where(sample_act[..., -1] > 0, 1.0, -1.0)
            return (pred == actions[..., -1]).float().mean()

        return {
            "sampled_plan_pp": sampled_plan_pp,
            "sampled_plan_pr": sampled_plan_pr,
            "action_loss_pp": action_loss_pp,
            "action_loss_pr": action_loss_pr,
            "kl_loss": kl_loss * (self.cfg.loss.kl_beta if kl_beta is None else kl_beta),
            "mae_pp": mae(sample_act_pp),
            "mae_pr": mae(sample_act_pr),
            "gripper_sr_pp": gripper_sr(sample_act_pp),
            "gripper_sr_pr": gripper_sr(sample_act_pr),
            "seq_feat": seq_feat,
        }

    def gcbc_val(
        self,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        actions: torch.Tensor,
        robot_obs: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        """GCBC's validation pass: the window decoded once from the empty
        plan (its action noise ``u_mix_pp`` / ``u_inv_pp`` of ``noise``, or
        from ``generator``), reported under the ``*_pp`` and ``*_pr`` names
        alike, with a (B, 1) zero plan and a zero KL (JAX's schema)."""
        noise = {} if noise is None else {k: mesh.local_rows(v) for k, v in noise.items()}
        if not set(noise) <= {"u_mix_pp", "u_inv_pp"}:
            raise ValueError(f"gcbc validation draws only the action noise, not {sorted(noise)}")
        b = actions.shape[0]
        action_loss, sample_act = self.action_decoder.loss_and_act(
            self.empty_plan(b), perceptual_emb, latent_goal, actions, robot_obs, generator=generator,
            u_mix=noise.get("u_mix_pp"), u_inv=noise.get("u_inv_pp"),
        )
        _, seq_feat = self.plan_recognition(perceptual_emb)
        mae = (sample_act[..., :-1] - actions[..., :-1]).abs().mean(dim=1)
        gripper_sr = (torch.where(sample_act[..., -1] > 0, 1.0, -1.0) == actions[..., -1]).float().mean()
        zero_plan = torch.zeros((b, 1), device=actions.device)
        return {
            "sampled_plan_pp": zero_plan, "sampled_plan_pr": zero_plan,
            "action_loss_pp": action_loss, "action_loss_pr": action_loss,
            "kl_loss": torch.zeros((), device=actions.device),
            "mae_pp": mae, "mae_pr": mae, "gripper_sr_pp": gripper_sr, "gripper_sr_pr": gripper_sr,
            "seq_feat": seq_feat,
        }

    def val_metrics(
        self,
        batch: Dict[str, ModalityBatch],
        kl_beta: Optional[float] = None,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Validation metrics of one preprocessed batch, a pass per modality
        (the JAX package's keys; ``sampled_plan_*`` are the only non-scalar
        entries). Runs in eval mode only: the plan recognition is
        deterministic there, as JAX's ``deterministic=True``."""
        if self.training:
            raise RuntimeError("val_metrics runs in eval mode (model.eval()): dropout would be drawn")
        cfg = self.cfg
        out: Dict[str, torch.Tensor] = {}
        total_pp = torch.zeros((), device=self.device)
        for scope, mod in batch.items():
            perceptual_emb, _ = self.encode(mod.rgb_obs(), mod.robot_obs, mod.depth_obs())
            if "lang" in scope:
                latent_goal = self.encode_language_goal(mod.lang)
            else:
                latent_goal = self.encode_visual_goal(perceptual_emb[:, -1])
            scope_noise = None if noise is None else noise[scope]
            if self.gcbc:
                m = self.gcbc_val(perceptual_emb, latent_goal, mod.actions, mod.state_info_robot_obs,
                                  generator=generator, noise=scope_noise)
            else:
                m = self.lmp_val(perceptual_emb, latent_goal, mod.actions, mod.state_info_robot_obs, kl_beta,
                                 generator=generator, noise=scope_noise)
            if "lang" in scope and cfg.use_clip_auxiliary_loss:
                out["val_pred_clip_loss"] = self.clip_loss(m["seq_feat"], latent_goal, mod.use_for_aux_lang_loss)
            total_pp = total_pp + m["action_loss_pp"]
            for name in ("action_loss_pp", "action_loss_pr", "kl_loss", "gripper_sr_pp", "gripper_sr_pr"):
                out[f"{scope}_{name}"] = m[name]
            for tag in ("pp", "pr"):
                mae = m[f"mae_{tag}"]
                out[f"{scope}_mae_{tag}"] = mae.mean()
                out[f"{scope}_pos_mae_{tag}"] = mae[..., :3].mean()
                out[f"{scope}_orn_mae_{tag}"] = mae[..., 3:6].mean()
            out[f"sampled_plan_pp_{scope}"] = m["sampled_plan_pp"]
            out[f"sampled_plan_pr_{scope}"] = m["sampled_plan_pr"]
        out["action_loss_pp"] = total_pp / float(len(batch))
        return out

    # ------------------------------------------------------------------
    # auxiliary losses (the language half only, masked)
    # ------------------------------------------------------------------

    def clip_loss(self, seq_feat: torch.Tensor, latent_goal: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        img_f, txt_f = self.proj_vis_lang(seq_feat, latent_goal)
        return masked_clip_loss(img_f, txt_f, torch.exp(self.logit_scale), mask)

    def bc_z_loss(self, seq_feat: torch.Tensor, gt_lang: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return masked_bc_z_loss(self.bc_z_lang_decoder(seq_feat), gt_lang, mask)

    def mia_loss(self, seq_feat: torch.Tensor, latent_goal: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """MIA's matching loss of the projections (``masked_mia_loss``)."""
        img_f, txt_f = self.proj_vis_lang(seq_feat, latent_goal)
        return masked_mia_loss(self.mia_lang_discriminator, img_f, txt_f, mask)

    def _lang_aux(self, totals: Dict[str, torch.Tensor], seq_feat, latent_goal, lang_emb, mask) -> None:
        """Add the language half's auxiliary losses to ``totals``."""
        cfg = self.cfg
        if cfg.use_bc_z_auxiliary_loss:
            totals["lang_pred_loss"] = totals["lang_pred_loss"] + self.bc_z_loss(seq_feat, lang_emb, mask)
        if cfg.use_clip_auxiliary_loss:
            totals["lang_clip_loss"] = totals["lang_clip_loss"] + self.clip_loss(seq_feat, latent_goal, mask)
        if cfg.use_mia_auxiliary_loss:
            totals["lang_contrastive_loss"] = totals["lang_contrastive_loss"] + self.mia_loss(
                seq_feat, latent_goal, mask)

    def _add_aux(self, totals: Dict[str, torch.Tensor]) -> None:
        """Each auxiliary loss into ``total_loss`` with its beta, in JAX's order."""
        cfg, beta = self.cfg, self.cfg.loss
        for on, key, b in ((cfg.state_recons, "proprio_loss", beta.state_recon_beta),
                           (cfg.use_bc_z_auxiliary_loss, "lang_pred_loss", beta.bc_z_auxiliary_loss_beta),
                           (cfg.use_mia_auxiliary_loss, "lang_contrastive_loss", beta.mia_auxiliary_loss_beta),
                           (cfg.use_clip_auxiliary_loss, "lang_clip_loss", beta.clip_auxiliary_loss_beta)):
            if on:
                totals["total_loss"] = totals["total_loss"] + b * totals[key]

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _gcbc_action_loss(self, perceptual_emb, latent_goal, actions, robot_obs, per_sample=False):
        """GCBC's action loss from the empty plan, and ``seq_feat`` (the
        recognition still runs, for the auxiliary losses)."""
        loss = self.action_decoder.loss(self.empty_plan(actions.shape[0]), perceptual_emb, latent_goal, actions,
                                        robot_obs, per_sample=per_sample)
        _, seq_feat = self.plan_recognition(perceptual_emb)
        return loss, seq_feat

    def _fused_train_losses(
        self,
        batch: Dict[str, ModalityBatch],
        kl_beta: float,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
        normal: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One 2B-batch pass over [vis; lang]: {"fused": 2B} as the loader
        stacked it, or {"vis", "lang"} stacked here. ``gumbel`` (2B,
        category_size, class_size) or ``normal`` (2B, plan_features) is the
        plan's noise. Under ``parallel.mesh.sharded_rows`` a rank holds
        [vis_r; lang_r] and the global noise is cut to those rows."""
        with mesh.row_blocks(2):
            return self._fused_pass(batch, kl_beta, generator, mesh.local_rows(gumbel), mesh.local_rows(normal))

    def _fused_pass(self, batch, kl_beta, generator, gumbel, normal) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if "fused" in batch:
            fused = batch["fused"]
            b = fused.actions.shape[0] // 2
        else:
            fused = fuse_modalities(batch["vis"], batch["lang"])
            b = batch["vis"].actions.shape[0]
        lang_emb, aux_mask = fused.lang, fused.use_for_aux_lang_loss
        perceptual_emb, visual_emb = self.encode(fused.rgb_obs(), fused.robot_obs, fused.depth_obs())
        with mesh.row_blocks(1):  # the goal encoders see one modality's rows
            latent_goal = torch.cat([
                self.encode_visual_goal(perceptual_emb[:b, -1]), self.encode_language_goal(lang_emb)
            ], dim=0)

        zero = torch.zeros((), device=perceptual_emb.device)
        totals = {k: zero for k in LOSS_KEYS}
        if cfg.state_recons:
            # the fused mean is the mean of the halves' means (equal sizes)
            totals["proprio_loss"] = self.perceptual_encoder.state_reconstruction_loss(visual_emb, fused.robot_obs)
        if self.gcbc:
            _refuse_plan_noise(gumbel, normal)
            act_ps, seq_feat = self._gcbc_action_loss(
                perceptual_emb, latent_goal, fused.actions, fused.state_info_robot_obs, per_sample=True)
            kl_ps = torch.zeros((2 * b,), device=act_ps.device)
        else:
            pp_state = self.plan_proposal(perceptual_emb[:, 0], latent_goal)
            pr_state, seq_feat = self.plan_recognition(perceptual_emb)
            sampled_plan, kl_ps = self._plan_and_kl(pp_state, pr_state, generator, gumbel, normal)
            act_ps = self.action_decoder.loss(
                sampled_plan, perceptual_emb, latent_goal, fused.actions, fused.state_info_robot_obs,
                per_sample=True,
            )
            kl_ps = kl_beta * kl_ps

        self._lang_aux(totals, seq_feat[b:], latent_goal[b:], lang_emb, aux_mask)
        per_mod = {}
        for scope, sl in (("vis", slice(0, b)), ("lang", slice(b, None))):
            act, kl = act_ps[sl].mean(), kl_ps[sl].mean()
            per_mod[f"action_loss_{scope}"] = act
            per_mod[f"kl_loss_scaled_{scope}"] = kl
            per_mod[f"total_loss_{scope}"] = act + kl
        totals["action_loss"] = act_ps.mean()
        totals["kl_loss"] = kl_ps.mean()
        totals["total_loss"] = totals["action_loss"] + totals["kl_loss"]
        self._add_aux(totals)
        totals.update(per_mod)
        return totals

    def train_losses(
        self,
        batch: Dict[str, ModalityBatch],
        kl_beta: float,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Union[None, torch.Tensor, Dict[str, torch.Tensor]] = None,
        normal: Union[None, torch.Tensor, Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One optimizer step's losses. ``{"fused": 2B}`` (and, with
        ``cfg.fuse_modalities``, equal-shaped ``{"vis", "lang"}``) takes the
        fused pass; otherwise one pass per modality, each with its own
        ``gumbel[scope]`` / ``normal[scope]``."""
        cfg = self.cfg
        if "fused" in batch or (
            cfg.fuse_modalities
            and set(batch) == {"vis", "lang"}
            and batch["vis"].actions.shape == batch["lang"].actions.shape
            and _same_shape(batch["vis"].rgb_static, batch["lang"].rgb_static)
        ):
            return self._fused_train_losses(batch, kl_beta, generator=generator, gumbel=gumbel, normal=normal)
        zero = torch.zeros((), device=self.device)
        totals = {k: zero for k in LOSS_KEYS}
        per_mod = {}
        for scope, mod in batch.items():
            perceptual_emb, visual_emb = self.encode(mod.rgb_obs(), mod.robot_obs, mod.depth_obs())
            if cfg.state_recons:
                totals["proprio_loss"] = totals["proprio_loss"] + self.perceptual_encoder.state_reconstruction_loss(
                    visual_emb, mod.robot_obs)
            if "lang" in scope:
                latent_goal = self.encode_language_goal(mod.lang)
            else:
                latent_goal = self.encode_visual_goal(perceptual_emb[:, -1])
            if self.gcbc:
                _refuse_plan_noise(gumbel, normal)
                act_loss, seq_feat = self._gcbc_action_loss(
                    perceptual_emb, latent_goal, mod.actions, mod.state_info_robot_obs)
                kl = zero
            else:
                out = self.lmp_train(
                    perceptual_emb, latent_goal, mod.actions, mod.state_info_robot_obs,
                    generator=generator, gumbel=None if gumbel is None else mesh.local_rows(gumbel[scope]),
                    normal=None if normal is None else mesh.local_rows(normal[scope]),
                )
                act_loss, kl, seq_feat = out["action_loss"], out["kl_loss"] * kl_beta, out["seq_feat"]
            if "lang" in scope:
                self._lang_aux(totals, seq_feat, latent_goal, mod.lang, mod.use_for_aux_lang_loss)
            totals["kl_loss"] = totals["kl_loss"] + kl
            totals["action_loss"] = totals["action_loss"] + act_loss
            totals["total_loss"] = totals["total_loss"] + act_loss + kl
            per_mod[f"action_loss_{scope}"] = act_loss
            per_mod[f"kl_loss_scaled_{scope}"] = kl
            per_mod[f"total_loss_{scope}"] = act_loss + kl
        n = float(len(batch))
        for key in ("kl_loss", "action_loss", "total_loss") + (("proprio_loss",) if cfg.state_recons else ()):
            totals[key] = totals[key] / n
        self._add_aux(totals)
        totals.update(per_mod)
        return totals


def _refuse_plan_noise(gumbel, normal) -> None:
    if gumbel is not None or normal is not None:
        raise ValueError("a gcbc model draws no plan noise: pass no gumbel / normal")


def _same_shape(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None and a.shape == b.shape)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, at torch's default scales: Linear and
    Conv2d U(+-1/sqrt(fan_in)), RNN U(+-1/sqrt(H)), attention in-projection
    U(+-1/sqrt(d)) with zero bias, position embeddings N(0, 0.02), LayerNorm
    (1, 0), the CLIP logit scale log(1/0.07); a module's other parameters
    by its ``init_params_`` (the frozen towers' BatchNorm statistics (1, 0,
    0, 1), class and position embeddings N(0, 0.02) / N(0, 0.01))."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (ScanRNN, ScanBiRNN)):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, MultiheadSelfAttention):
            bound = 1.0 / math.sqrt(m.in_proj_weight.shape[1])
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, SpatialSoftmax) and m.fixed_temperature is None:
            m.temperature.fill_(1.0)
        if hasattr(m, "init_params_"):  # the frozen towers' own parameters (models.clip, models.tactile)
            m.init_params_(generator)
    if isinstance(model, HulcModel) and model.cfg.use_clip_auxiliary_loss:
        model.logit_scale.fill_(math.log(1 / 0.07))


def make_model(cfg: HulcConfig, device="cuda", seed: int = 0, use_kernels: bool = True) -> HulcModel:
    """Build the model on ``device`` (CUDA unless the caller asks for
    another), randomly initialized from ``seed``, in eval mode."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = HulcModel(cfg, use_kernels)
    model.to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()
