"""Language side of the data layer (port of hulc_tpu/data/language.py).

Only the task-pool restriction the evaluator needs is here; the embedding
backends and the annotation tooling are ported with the data layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def restrict_task_pool(lang_embeddings: Optional[Dict[str, np.ndarray]], all_tasks, min_pool: int = 5):
    """Tasks evaluable with the available embeddings (chains need >= min_pool)."""
    if not lang_embeddings:
        return list(all_tasks)
    pool = sorted(set(all_tasks) & set(lang_embeddings))
    if len(pool) < min_pool:
        pool = sorted(lang_embeddings)
    return pool
