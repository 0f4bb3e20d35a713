"""Warm starts (port of hulc_tpu/training/pretrain.py; reference
hulc/utils/utils.py:7-16 initialize_pretrained_weights): the parameters of a
previous run, an epoch checkpoint or a reference torch checkpoint grafted
onto a fresh model, the plan recognition's position-embedding table resized
when the window sizes differ, and the plan recognition optionally left out
("in_exclude_pr").

The port works on state_dicts. A subtree is a key's first dotted component
(``plan_recognition`` of ``plan_recognition.position_embeddings.weight``),
as a subtree of the JAX params is a top-level key. The port's modules carry
the reference's torch state_dict keys, so a reference ``.ckpt``'s
``state_dict`` loads as it is; its keys the port lacks (buffers, heads of
options the port does not build) are left out and listed, as JAX's
converter lists the keys it does not map.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

POSITION_EMBEDDINGS = "plan_recognition.position_embeddings.weight"


def subtree(key: str) -> str:
    """The top-level module a state_dict key belongs to."""
    return key.split(".", 1)[0]


def _resize_position_embeddings(params: Dict[str, torch.Tensor], target_rows: int) -> None:
    """Resize the table in place to ``target_rows``: a trim keeps its first
    rows (the reference's behaviour), an extension appends rows drawn as
    JAX draws them, ``np.random.default_rng(0).normal(0, 0.02, ...)``."""
    if POSITION_EMBEDDINGS not in params:
        return
    pe = params[POSITION_EMBEDDINGS]
    if pe.shape[0] == target_rows:
        return
    if pe.shape[0] > target_rows:
        params[POSITION_EMBEDDINGS] = pe[:target_rows].clone()
    else:
        extra = np.random.default_rng(0).normal(0, 0.02, (target_rows - pe.shape[0], pe.shape[1]))
        params[POSITION_EMBEDDINGS] = torch.cat([pe, torch.from_numpy(extra).to(pe.device, pe.dtype)], dim=0)


def initialize_pretrained_weights(
    target_params: Mapping[str, torch.Tensor],
    source_params: Mapping[str, torch.Tensor],
    exclude_plan_recognition: bool = False,
) -> Dict[str, torch.Tensor]:
    """Graft ``source_params`` onto a freshly initialized state_dict.

    A subtree present in both is taken whole from the source; a subtree
    only the target has keeps its fresh init. The position-embedding table
    is resized to the target's rows."""
    source_subtrees = {subtree(k) for k in source_params}
    target_subtrees = {subtree(k) for k in target_params}
    taken = {t for t in source_subtrees & target_subtrees if not (exclude_plan_recognition and t == "plan_recognition")}
    out = {}
    for k, v in target_params.items():  # in the target's order
        if subtree(k) not in taken:
            out[k] = v
        elif k in source_params:
            out[k] = source_params[k]
    out.update({k: v for k, v in source_params.items() if subtree(k) in taken and k not in out})
    if POSITION_EMBEDDINGS in out and POSITION_EMBEDDINGS in target_params:
        _resize_position_embeddings(out, target_params[POSITION_EMBEDDINGS].shape[0])
    return out


def read_torch_checkpoint(path, target_params: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A Lightning ``.ckpt`` (its ``state_dict``) or a raw state_dict
    ``.pt`` / ``.pth`` on the CPU: the entries the target's keys name, and
    the sorted keys it lacks (JAX's ``load_torch_checkpoint`` lists the keys
    its converter does not map)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    kept = {k: v for k, v in sd.items() if k in target_params}
    return kept, sorted(set(sd) - set(target_params))


def load_pretrained(path, target_params: Mapping[str, torch.Tensor], exclude_plan_recognition: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A warm-start source grafted onto ``target_params``: a reference
    ``.ckpt`` / ``.pt`` / ``.pth``, a run directory (its latest epoch
    checkpoint) or an epoch checkpoint directory of the port."""
    from hulc_tpu_torch.training import checkpoint as ckpt

    path = pathlib.Path(path)
    if path.suffix in (".ckpt", ".pt", ".pth"):
        source, _ = read_torch_checkpoint(path, target_params)
    else:
        ckpt_path = ckpt.latest_checkpoint(path) if (path / "saved_models").exists() else path
        source = ckpt.restore_checkpoint(ckpt_path, map_location="cpu")["params"]
    return initialize_pretrained_weights(target_params, source, exclude_plan_recognition)
