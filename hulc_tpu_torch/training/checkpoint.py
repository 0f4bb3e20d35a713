"""Checkpoints with the JAX package's resume semantics (port of
hulc_tpu/training/checkpoint.py), on ``torch.save``.

One directory per epoch, ``<run_dir>/saved_models/epoch_<N>``, holding
``state.pt``: the parameters, the optimizer's state, the step, the epoch
and the trainer's generator state. A save is atomic: the state is written
and synced into a hidden temporary directory, which is then renamed into
place. An existing ``epoch_<N>`` is renamed aside first (``.old-epoch_<N>-*``)
and deleted after; a save cut between the two renames leaves it aside,
where ``all_checkpoints`` finds it. So a save cut at any point leaves the
last complete checkpoint of every epoch. ``all_checkpoints`` lists only
directories that hold a ``state.pt``. ``restore_params`` reads the
parameters alone, matched to a template by name. ``MonitoredCheckpointer``
keeps the top-k epochs by a logged metric (``CHECKPOINT_PRESETS``),
journaled to ``saved_models/monitor.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import shutil
import uuid
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
_ASIDE_RE = re.compile(r"^\.old-epoch_(\d+)-")  # an epoch's checkpoint while a save replaces it
STATE_FILE = "state.pt"


def _ckpt_dir(run_dir) -> pathlib.Path:
    return pathlib.Path(run_dir) / "saved_models"


def save_checkpoint(run_dir, epoch: int, state: Dict[str, Any]) -> pathlib.Path:
    """Save ``state`` as epoch ``epoch``'s checkpoint, replacing an earlier
    one of that epoch atomically."""
    final = _ckpt_dir(run_dir) / f"epoch_{epoch}"
    final.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = final.parent / f".tmp-epoch_{epoch}-{tag}"
    tmp.mkdir()
    with open(tmp / STATE_FILE, "wb") as fh:
        torch.save(state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    if final.exists():
        os.rename(final, final.parent / f".old-epoch_{epoch}-{tag}")
    os.rename(tmp, final)
    for aside in final.parent.glob(f".old-epoch_{epoch}-*"):  # this save's, and one a cut save left
        shutil.rmtree(aside)
    return final


def restore_checkpoint(path, map_location=None) -> Dict[str, Any]:
    """The state a checkpoint directory holds."""
    return torch.load(pathlib.Path(path) / STATE_FILE, map_location=map_location, weights_only=True)


def restore_params(path, template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters of a checkpoint directory (evaluation and export need
    no optimizer state), matched to ``template`` (a state_dict) by NAME and
    in its order, on the template's devices. A checkpoint of another config
    fails loudly with the offending names or shapes instead of loading
    weights of the same count in the wrong places."""
    params = restore_checkpoint(path, map_location="cpu")["params"]
    missing = [n for n in template if n not in params]
    extra = sorted(set(params) - set(template))
    if missing or extra:
        raise ValueError(
            f"checkpoint params do not match template by name: "
            f"missing={missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"extra={extra[:5]}{'...' if len(extra) > 5 else ''}"
        )
    for name, t in template.items():
        if tuple(params[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint {tuple(params[name].shape)} "
                             f"vs template {tuple(t.shape)}")
    return {name: params[name].to(t.device) for name, t in template.items()}


def all_checkpoints(run_dir) -> List[pathlib.Path]:
    """Complete epoch checkpoints, by epoch; partial directories (no
    ``state.pt``) and temporary ones are skipped. An epoch whose
    ``epoch_<N>`` a cut save renamed aside is its ``.old-epoch_<N>-*``."""
    d = _ckpt_dir(run_dir)
    if not d.exists():
        return []
    found, aside = {}, {}
    for p in d.iterdir():
        if not (p.is_dir() and (p / STATE_FILE).is_file()):
            continue
        if m := _EPOCH_RE.match(p.name):
            found[int(m.group(1))] = p
        elif m := _ASIDE_RE.match(p.name):
            aside[int(m.group(1))] = p
    for epoch, p in aside.items():
        found.setdefault(epoch, p)
    return [found[e] for e in sorted(found)]


def latest_checkpoint(run_dir) -> Optional[pathlib.Path]:
    ckpts = all_checkpoints(run_dir)
    return ckpts[-1] if ckpts else None


def checkpoint_epoch(path) -> int:
    name = pathlib.Path(path).name
    m = _EPOCH_RE.match(name) or _ASIDE_RE.match(name)
    if not m:
        raise ValueError(f"not an epoch checkpoint: {path}")
    return int(m.group(1))


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """What to monitor and how many checkpoints to keep (top_k=-1: keep all)."""

    monitor: Optional[str] = None
    mode: str = "min"  # "min" or "max"
    top_k: int = -1

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {self.mode!r}")


#: The reference's checkpoint callbacks, keyed by the trainer's metric names.
CHECKPOINT_PRESETS: Dict[str, CheckpointPolicy] = {
    "all": CheckpointPolicy(),
    "val_action": CheckpointPolicy("val/action_loss_pp", "min", -1),
    "lh_sr": CheckpointPolicy("eval_lh/avg_seq_len", "max", 3),
    "task_sr": CheckpointPolicy("tasks/average_sr", "max", 3),
    "kl": CheckpointPolicy("train/kl_loss", "max", 3),
    "clip_loss": CheckpointPolicy("val/val_pred_clip_loss", "min", 3),
    "state_recon": CheckpointPolicy("val/proprio_loss", "min", 3),
}


def resolve_checkpoint_policy(policy: Union[str, CheckpointPolicy, None]) -> CheckpointPolicy:
    if policy is None:
        return CHECKPOINT_PRESETS["all"]
    if isinstance(policy, CheckpointPolicy):
        return policy
    try:
        return CHECKPOINT_PRESETS[policy]
    except KeyError:
        raise ValueError(
            f"unknown checkpoint preset {policy!r}; choose from {sorted(CHECKPOINT_PRESETS)}"
        ) from None


class MonitoredCheckpointer:
    """Per-epoch saves with optional top-k retention by a metric.

    The most recent checkpoint is always kept (resume needs it); pruning
    applies to older epochs beyond the top-k best monitored values. Epochs
    saved while the monitored metric was absent carry no score and are
    pruned first.
    """

    def __init__(self, run_dir, policy: Union[str, CheckpointPolicy, None] = None):
        self.run_dir = pathlib.Path(run_dir)
        self.policy = resolve_checkpoint_policy(policy)
        self._journal_path = _ckpt_dir(run_dir) / "monitor.json"
        self._journal: Dict[str, Dict[str, float]] = {}
        if self._journal_path.exists():
            self._journal = json.loads(self._journal_path.read_text())

    def save(self, epoch: int, state: Dict[str, Any], metrics: Optional[Dict[str, float]] = None) -> pathlib.Path:
        path = save_checkpoint(self.run_dir, epoch, state)
        # journal every scalar metric so any monitor can be queried later
        self._journal[str(epoch)] = {
            k: float(v) for k, v in (metrics or {}).items() if isinstance(v, (int, float))
        }
        self._journal_path.parent.mkdir(parents=True, exist_ok=True)
        self._journal_path.write_text(json.dumps(self._journal, indent=2))
        self._prune()
        return path

    def _score(self, epoch: int) -> Optional[float]:
        return self._journal.get(str(epoch), {}).get(self.policy.monitor)

    def _prune(self) -> None:
        k = self.policy.top_k
        if k < 0 or self.policy.monitor is None:
            return
        ckpts = all_checkpoints(self.run_dir)
        if len(ckpts) <= k:
            return
        latest = ckpts[-1]
        sign = 1.0 if self.policy.mode == "min" else -1.0

        # rank by monitored value; unscored epochs sort last (pruned first)
        def rank(p):
            s = self._score(checkpoint_epoch(p))
            return (0, sign * s) if s is not None else (1, 0.0)

        keep = set(sorted(ckpts, key=rank)[:k])
        keep.add(latest)
        for p in ckpts:
            if p not in keep:
                shutil.rmtree(p)

    def best(self) -> Optional[pathlib.Path]:
        return best_checkpoint(self.run_dir, self.policy)


def best_checkpoint(run_dir, policy: Union[str, CheckpointPolicy, None] = None) -> Optional[pathlib.Path]:
    """The checkpoint with the best monitored value (the latest when no
    monitor journal exists, as with preset 'all')."""
    policy = resolve_checkpoint_policy(policy)
    journal_path = _ckpt_dir(run_dir) / "monitor.json"
    ckpts = all_checkpoints(run_dir)
    if not ckpts:
        return None
    if policy.monitor is None or not journal_path.exists():
        return ckpts[-1]
    journal = json.loads(journal_path.read_text())
    scored = [
        (journal.get(str(checkpoint_epoch(p)), {}).get(policy.monitor), p) for p in ckpts
    ]
    scored = [(s, p) for s, p in scored if s is not None]
    if not scored:
        return ckpts[-1]
    best_fn = min if policy.mode == "min" else max
    return best_fn(scored, key=lambda sp: sp[0])[1]
