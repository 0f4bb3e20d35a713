"""Language side of the data layer (port of hulc_tpu/data/language.py).

The validation embeddings' reader the export CLI needs and the task-pool
restriction the evaluator needs are here; the embedding backends and the
annotation tooling are not ported yet (ROADMAP A.6, its first bullet: the
data CLI).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def load_task_embeddings(path) -> Dict[str, np.ndarray]:
    """validation embeddings.npy -> {task: (384,) embedding}."""
    raw = np.load(path, allow_pickle=True).item()
    return {k: np.asarray(v["emb"], np.float32).reshape(-1) for k, v in raw.items()}


def restrict_task_pool(lang_embeddings: Optional[Dict[str, np.ndarray]], all_tasks, min_pool: int = 5):
    """Tasks evaluable with the available embeddings (chains need >= min_pool)."""
    if not lang_embeddings:
        return list(all_tasks)
    pool = sorted(set(all_tasks) & set(lang_embeddings))
    if len(pool) < min_pool:
        pool = sorted(lang_embeddings)
    return pool
