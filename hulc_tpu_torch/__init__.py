"""PyTorch/CUDA port of hulc_tpu for NVIDIA Hopper.

The JAX package ``hulc_tpu`` is the reference; this package mirrors its
module layout (``config``, ``ops``, ``models``, ``data``, ``training``,
``evaluation``, ``utils``) so each counterpart is found under the same
name. The hot ops that the JAX package
shaped by hand for the TPU are hand-written CUDA kernels here
(``csrc/*.cu``, bound by ``kernels.py``), each with a plain PyTorch version
beside its wrapper: CPU tensors take the plain version, CUDA tensors launch
the kernel or raise.

This package imports torch and never jax, and nothing of hulc_tpu; the
check below enforces it for every module imported here.
"""

import sys as _sys

_FORBIDDEN = ("jax", "hulc_tpu")
_PRELOADED = {_name for _name in _FORBIDDEN if _name in _sys.modules}

from hulc_tpu_torch import config, convert, kernels  # noqa: E402,F401
from hulc_tpu_torch.data import dataset, fixtures, language, loader, shm_store, transforms  # noqa: E402,F401
from hulc_tpu_torch.evaluation import (  # noqa: E402,F401
    batched_eval, chain_sampler, expert, fake_env, lh_eval, metrics, policy, tasks,
)
from hulc_tpu_torch.training import checkpoint, trainer  # noqa: E402,F401
from hulc_tpu_torch.utils import loggers  # noqa: E402,F401

_LEAKED = {_name for _name in _FORBIDDEN if _name in _sys.modules} - _PRELOADED
if _LEAKED:
    raise ImportError(f"hulc_tpu_torch must not import {sorted(_LEAKED)}")
