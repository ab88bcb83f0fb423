"""Structured logging for ptype_tpu_torch.

The reference uses zap with a global dev logger swapped in when
``Debug: true`` (cluster/cluster.go:29-35) and structured key-value fields
on every event (e.g. registry.go:77-82). We mirror that: stdlib ``logging``
with a key-value formatter, a package-root logger, and ``set_debug`` to flip
the global level the way ``zap.ReplaceGlobals`` did.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Any

from ptype_tpu_torch import trace as trace_mod

_ROOT_NAME = "ptype_tpu_torch"
_configured = False
_lock = threading.Lock()


class _KVFormatter(logging.Formatter):
    """``ts level logger msg k=v k=v`` — zap's dev-console shape."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        base = f"{ts}.{int(record.msecs):03d} {record.levelname:<5} {record.name} {record.getMessage()}"
        fields = getattr(record, "kv", None)
        if fields:
            kv = " ".join(f"{k}={v!r}" for k, v in fields.items())
            base = f"{base} {kv}"
        if record.exc_info:
            base = f"{base}\n{self.formatException(record.exc_info)}"
        return base


class KVLogger(logging.LoggerAdapter):
    """Logger adapter carrying structured fields via ``kv=`` kwargs.

    When the calling thread is inside an active trace span
    (:mod:`ptype_tpu_torch.trace`), ``trace_id``/``span_id`` are attached
    automatically — logs and traces correlate with zero call-site
    changes (grep a trace_id across every process's logs, or jump from
    a log line into the stitched Perfetto view). Costs one enabled
    check per log call when tracing is off."""

    def process(self, msg, kwargs):
        kv = kwargs.pop("kv", None)
        sp = trace_mod.current()
        if sp is not None:
            kv = dict(kv) if kv else {}
            kv.setdefault("trace_id", sp.trace_id)
            kv.setdefault("span_id", sp.span_id)
        extra = kwargs.setdefault("extra", {})
        extra["kv"] = kv
        return msg, kwargs


def _configure() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT_NAME)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(_KVFormatter())
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True


def get_logger(name: str = "") -> KVLogger:
    """Return a structured logger under the ``ptype_tpu_torch`` root."""
    _configure()
    full = f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME
    return KVLogger(logging.getLogger(full), {})


def set_debug(debug: bool) -> None:
    """Flip global verbosity."""
    _configure()
    logging.getLogger(_ROOT_NAME).setLevel(
        logging.DEBUG if debug else logging.INFO
    )


def log_kv(logger: KVLogger, level: int, msg: str, **fields: Any) -> None:
    logger.log(level, msg, kv=fields)
