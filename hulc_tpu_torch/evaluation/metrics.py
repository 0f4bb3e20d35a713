"""Validation-only diagnostics (port of hulc_tpu/evaluation/metrics.py).

``clip_groundtruth_metrics`` ranks ground-truth task ids by CLIP similarity
between the plan-recognition features of language windows and a bank of
encoded instructions; the projections run in the model, the ranking in
fp64 numpy, as in the JAX package. ``ClipGroundtruthCallback`` logs them as
``lang_gt`` after each validation epoch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


@torch.no_grad()
def clip_groundtruth_metrics(
    model,
    seq_feat: torch.Tensor,
    gt_task_ids: np.ndarray,
    bank_lang_emb: np.ndarray,
    bank_task_ids: np.ndarray,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Ranking score and success rate of matching the (B, F) visual
    features to the (N, 384) instruction bank; ``mask`` is the (B,)
    ``use_for_aux_lang_loss`` mask. Empty when no window is masked in."""
    if mask is None:
        mask = np.ones(len(gt_task_ids), bool)
    mask = np.asarray(mask, bool)
    if not mask.any():
        return {}
    device = seq_feat.device
    encoded_bank = model.encode_language_goal(torch.as_tensor(np.asarray(bank_lang_emb, np.float32), device=device))
    img_f, lang_f = model.proj_vis_lang(seq_feat, encoded_bank)
    img_f = img_f.cpu().numpy().astype(np.float64)
    lang_f = lang_f.cpu().numpy().astype(np.float64)
    img_f /= np.linalg.norm(img_f, axis=-1, keepdims=True)
    lang_f /= np.linalg.norm(lang_f, axis=-1, keepdims=True)
    logit_scale = float(np.exp(model.logit_scale.detach().cpu().numpy()))
    scores = logit_scale * img_f @ lang_f.T  # (B, N)

    # min-max normalize each row
    mins = scores.min(axis=1, keepdims=True)
    maxs = scores.max(axis=1, keepdims=True)
    norm = (scores - mins) / np.maximum(maxs - mins, 1e-9)

    gt = np.asarray(gt_task_ids)
    bank = np.asarray(bank_task_ids)
    score_terms = []
    for i in np.where(mask)[0]:
        pos = norm[i, bank == gt[i]].sum()
        neg = norm[i, bank != gt[i]].sum()
        score_terms.append(pos - neg)
    pred = bank[np.argmax(scores, axis=1)]
    sr = float(np.mean(pred[mask] == gt[mask]))
    return {"lang_gt_score": float(np.mean(score_terms)), "lang_gt_sr": sr}


class ClipGroundtruthCallback:
    """Per-epoch ``lang_gt`` diagnostics from the validation language
    sampler: the instruction bank is one embedding per annotation, labelled
    by task; each val window's recognition features are ranked against it."""

    def __init__(self, val_loader, max_batches: int = 4):
        self.val_loader = val_loader
        self.max_batches = max_batches
        sampler = val_loader.loaders["lang"].sampler
        tasks = sorted(set(sampler.tasks))
        self._task_to_id = {t: i for i, t in enumerate(tasks)}
        self.bank_emb = np.asarray(sampler.embeddings, np.float32)
        self.bank_ids = np.asarray([self._task_to_id[t] for t in sampler.tasks])
        self._sampler = sampler

    @torch.no_grad()
    def on_epoch_end(self, trainer, epoch: int):
        from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch

        model = trainer.model
        was_training = model.training
        model.eval()
        metrics_acc = []
        lang_loader = self.val_loader.loaders["lang"]
        try:
            for i in range(self.max_batches):
                # language windows only: no vision-modality gathers
                lang_batch = lang_loader.deterministic_batch(i)
                raw = batch_to_device({"lang": lang_batch}, trainer.device)
                prep = preprocess_batch(trainer.cfg, raw, train=False, use_kernels=trainer.use_kernels)["lang"]
                emb, _ = model.encode(prep.rgb_obs(), prep.robot_obs, prep.depth_obs())
                _, seq_feat = model.plan_recognition(emb)
                gt = np.asarray([self._task_to_id[self._sampler.tasks[int(j)]] for j in lang_batch.idx])
                m = clip_groundtruth_metrics(
                    model, seq_feat, gt, self.bank_emb, self.bank_ids,
                    mask=np.asarray(lang_batch.use_for_aux_lang_loss),
                )
                if m:
                    metrics_acc.append(m)
        finally:
            model.train(was_training)
        if not metrics_acc:
            return None
        mean = {k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]}
        trainer.logger.log(mean, trainer.step, "lang_gt")
        print(f"[lang_gt] epoch {epoch}: sr={mean['lang_gt_sr']:.3f}")
        return mean
