"""Serving: ``torch.export`` policy artifacts and a runtime without model
code (port of hulc_tpu/serving).

``ServedPolicy`` / ``ServedBatchedPolicy`` import eagerly (torch, numpy
and the port's kernel ops only); ``export_policy`` is lazy, so a serving
host never imports the model code.
"""

from hulc_tpu_torch.serving.params_io import flatten_params, unflatten_params
from hulc_tpu_torch.serving.runtime import ServedBatchedPolicy, ServedPolicy

__all__ = [
    "export_policy",
    "flatten_params",
    "unflatten_params",
    "ServedPolicy",
    "ServedBatchedPolicy",
]


def __getattr__(name):
    if name == "export_policy":
        from hulc_tpu_torch.serving.export import export_policy

        return export_policy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
