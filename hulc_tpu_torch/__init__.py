"""PyTorch/CUDA port of hulc_tpu for NVIDIA Hopper.

The JAX package ``hulc_tpu`` is the reference; this package mirrors its
module layout (``config``, ``ops``, ``models``, ``data``, ``training``,
``parallel``, ``evaluation``, ``serving``, ``utils``) so each counterpart is found under
the same name. The hot ops that the JAX package
shaped by hand for the TPU are hand-written CUDA kernels here
(``csrc/*.cu``, bound by ``kernels.py``), each with a plain PyTorch version
beside its wrapper: CPU tensors take the plain version, CUDA tensors launch
the kernel or raise.

Importing the package loads no submodule: each loads at first use
(``hulc_tpu_torch.config`` or ``import hulc_tpu_torch.config``), so the
serving runtime loads without the model code. This package imports torch
and never jax, and nothing of hulc_tpu; a submodule loaded through this
package's attributes is checked for it, and the tests check every module.
"""

import importlib as _importlib
import sys as _sys

_FORBIDDEN = ("jax", "hulc_tpu")
_SUBMODULES = ("config", "convert", "data", "device", "evaluation", "kernels", "models", "ops", "parallel",
               "serving", "training", "utils")


def __getattr__(name):
    if name not in _SUBMODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    preloaded = {m for m in _FORBIDDEN if m in _sys.modules}
    module = _importlib.import_module(f"{__name__}.{name}")
    leaked = {m for m in _FORBIDDEN if m in _sys.modules} - preloaded
    if leaked:
        raise ImportError(f"hulc_tpu_torch must not import {sorted(leaked)}")
    return module
