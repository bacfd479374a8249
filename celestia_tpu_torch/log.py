"""Structured logging (port of the JAX package's log.py), the cosmos-sdk and
cometbft logger analogue.

``logger(module)`` returns a StructuredLogger whose info/debug/warn/error
take a message and key-value fields and emit ONE JSON line per event:

    {"ts": ..., "level": "info", "module": "store", "msg": ...,
     "height": 42, "error": "..."}

Quiet by default (WARNING, no handler output); ``configure(level)`` turns
it on. The logger tree is rooted at ``celestia_tpu_torch``. When a span of
the port's own ``tracing`` is open on the thread, its id is stamped on the
event, so a trace and the log tell one story.
"""

from __future__ import annotations

import json
import logging
import sys

_ROOT = "celestia_tpu_torch"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "module": record.name.removeprefix(_ROOT + "."),
            "msg": record.getMessage(),
        }
        payload.update(getattr(record, "kv", {}))
        return json.dumps(payload, sort_keys=False, default=_coerce)


def _coerce(value):
    if isinstance(value, bytes):
        return value.hex()
    return str(value)


class StructuredLogger:
    """cometbft-style leveled key-value logger: ``log.info("msg", height=1)``."""

    def __init__(self, module: str):
        self._log = logging.getLogger(f"{_ROOT}.{module}")

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        if self._log.isEnabledFor(level):
            try:
                from celestia_tpu_torch import tracing  # lazy: tracing is optional here

                sp = tracing.current()
                if sp is not None and sp.span_id is not None:
                    kv.setdefault("span_id", sp.span_id)
            except Exception:  # noqa: BLE001 (logging never breaks on tracing)
                pass
            self._log.log(level, msg, extra={"kv": kv})

    def debug(self, msg: str, **kv) -> None:
        self._emit(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit(logging.INFO, msg, kv)

    def warn(self, msg: str, **kv) -> None:
        self._emit(logging.WARNING, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit(logging.ERROR, msg, kv)


def logger(module: str) -> StructuredLogger:
    return StructuredLogger(module)


def configure(level: str = "info", stream=None) -> None:
    """Install the JSON handler on the ``celestia_tpu_torch`` logger tree."""
    root = logging.getLogger(_ROOT)
    root.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JsonFormatter())
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper()))
    root.propagate = False


# quiet unless configured (cosmos NewNopLogger's default)
logging.getLogger(_ROOT).addHandler(logging.NullHandler())
