"""Ops of the port; importing the package registers the ``hulc::`` ops
(``ops.library``) that the serving path's wrappers call."""

from hulc_tpu_torch.ops import library  # noqa: F401
