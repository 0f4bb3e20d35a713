"""Metric sinks (port of hulc_tpu/training/trainer.py:123-143 and
hulc_tpu/utils/loggers.py).

``MetricLogger`` appends one JSON line per call to ``<run_dir>/metrics.jsonl``
(``step``, ``prefix`` and every value that converts to a float); the
trainer always writes it (rank 0 of a process group; the other ranks hold a
``NullLogger``). ``TensorBoardLogger`` mirrors the same calls to
TensorBoard event files, ``MultiLogger`` fans out to several sinks. The
wandb sink is not ported.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Any, Dict


class MetricLogger:
    """The JSONL sink."""

    def __init__(self, run_dir):
        self.path = pathlib.Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train") -> None:
        rec = {"step": step, "prefix": prefix}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class NullLogger:
    """A sink that writes nothing: a trainer's on every rank but rank 0."""

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train") -> None:
        pass

    def close(self) -> None:
        pass


class TensorBoardLogger:
    """Scalars as TensorBoard events (``<prefix>/<key>`` tags) in
    ``<log_dir>/events.out.tfevents.<time>.<host>``, written as tensorboard's
    own records (tensorboard's file writer would load tensorflow)."""

    def __init__(self, log_dir: str):
        import socket

        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        path = pathlib.Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}"
        self._writer = RecordWriter(open(path / name, "wb"))
        self._write(self._event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._writer.write(event.SerializeToString())
        self._writer.flush()

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train") -> None:
        values = []
        for k, v in metrics.items():
            try:
                values.append(self._summary.Value(tag=f"{prefix}/{k}", simple_value=float(v)))
            except (TypeError, ValueError):
                continue
        if values:
            self._write(self._event(wall_time=time.time(), step=step, summary=self._summary(value=values)))

    def close(self) -> None:
        self._writer.close()


def make_logger(kind: str, run_dir: str):
    """kind: "jsonl" | "tensorboard"."""
    if kind == "tensorboard":
        return TensorBoardLogger(str(run_dir))
    if kind != "jsonl":
        raise ValueError(f"unknown logger kind {kind!r} (jsonl | tensorboard)")
    return MetricLogger(run_dir)


class MultiLogger:
    """Fan out to several sinks."""

    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log(self, metrics, step, prefix="train"):
        for lg in self.loggers:
            lg.log(metrics, step, prefix)

    def close(self):
        for lg in self.loggers:
            lg.close()
