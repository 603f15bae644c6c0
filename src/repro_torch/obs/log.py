"""repro_torch.obs.log — structured logging for scheduler threads.

Every failure path of the dispatcher goes through :func:`error`:

* a ``key=value`` structured log line (request ids, lane, exception)
  on the ``repro_torch.obs.<component>`` logger, and
* an increment of the ``dart_errors_total{component}`` counter in the
  global registry.

No handler is installed here: with nothing configured, Python's
last-resort handler prints WARNING+ to stderr, and an application that
configures ``logging`` owns the routing.  ``error`` never raises — it
runs inside except blocks on daemon threads.
"""
from __future__ import annotations

import logging

__all__ = ["get_logger", "error", "event"]

_BASE = "repro_torch.obs"


def get_logger(component: str = "") -> logging.Logger:
    name = f"{_BASE}.{component}" if component else _BASE
    return logging.getLogger(name)


def _kv(fields: dict) -> str:
    return " ".join(f"{k}={v!r}" for k, v in fields.items())


def event(component: str, msg: str, level: int = logging.INFO,
          **fields) -> None:
    """Structured (key=value) log line on ``repro_torch.obs.<component>``."""
    try:
        get_logger(component).log(level, "%s %s", msg, _kv(fields))
    except Exception:                              # noqa: BLE001
        pass


def error(component: str, msg: str, *, exc: BaseException | None = None,
          **fields) -> None:
    """Structured error + ``dart_errors_total{component}`` increment.
    Always counts (error paths are cold — the zero-cost-when-disabled
    budget is about the request hot path)."""
    try:
        from repro_torch.obs import OBS
        OBS.registry.counter(
            "dart_errors_total",
            "scheduler/dispatcher errors by component",
            ("component",)).inc(1, component=component)
        get_logger(component).error("%s %s", msg, _kv(fields),
                                    exc_info=exc)
    except Exception:                              # noqa: BLE001
        pass
