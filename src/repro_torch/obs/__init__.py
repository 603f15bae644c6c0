"""repro_torch.obs — the serving observability layer.

One switch, three surfaces, as in the JAX package's ``repro/obs``:

* **per-request tracing** (:mod:`repro_torch.obs.trace`) — host-side
  spans ``admit -> queue_wait -> bucket -> compiled_step -> exit |
  shed`` in a bounded drop-oldest ring; JSONL + Chrome ``trace_event``
  export.
* **metrics registry** (:mod:`repro_torch.obs.metrics`) — counters /
  gauges / histograms with label sets and a Prometheus text exposition
  (file and stdlib ``http.server`` endpoint); :mod:`repro_torch.obs.
  adapters` mirrors the serving signals into it (``EngineState``
  telemetry, per-lane DAES, queue depths, the kernels' launch counts).
* **structured logging** (:mod:`repro_torch.obs.log`) — the dispatcher
  thread's failure paths log ``key=value`` lines and count
  ``dart_errors_total``.

Usage::

    from repro_torch import obs
    obs.configure(enabled=True, textfile="artifacts/metrics.prom")
    server = AsyncDartServer(engine)        # instrumented
    ...
    obs.flush_textfile()
    print(obs.OBS.registry.render())        # Prometheus text

Disabled (the default), every instrumentation site is a single
``if OBS.enabled`` attribute check; spans are recorded only from host
scheduler code, and no device sync is added.
"""
from __future__ import annotations

import threading

from repro_torch.obs import log  # noqa: F401  (re-export)
from repro_torch.obs.metrics import (Registry, parse_prometheus,
                                     render_prometheus, start_http_server,
                                     write_textfile)
from repro_torch.obs.trace import Tracer, chrome_trace

__all__ = ["OBS", "configure", "reset", "is_enabled", "get_registry",
           "get_tracer", "flush_textfile", "Registry", "Tracer",
           "chrome_trace", "render_prometheus", "parse_prometheus",
           "log"]

DEFAULT_TRACE_CAPACITY = 16384


class _ObsState:
    """The process-wide observability switchboard.  Hot-path code reads
    ONE attribute (``OBS.enabled``) and does nothing else when off."""

    def __init__(self):
        self.enabled = False
        self.registry = Registry()
        self.tracer = Tracer(DEFAULT_TRACE_CAPACITY)
        self.textfile: str | None = None
        self._writer: threading.Thread | None = None
        self._writer_stop: threading.Event | None = None
        self._http = None

    @property
    def http_port(self) -> int | None:
        return None if self._http is None else self._http.server_address[1]


OBS = _ObsState()


def is_enabled() -> bool:
    return OBS.enabled


def get_registry() -> Registry:
    return OBS.registry


def get_tracer() -> Tracer:
    return OBS.tracer


def configure(enabled: bool | None = None, *,
              trace_capacity: int | None = None,
              textfile: str | None = None,
              textfile_interval_s: float | None = None,
              http_port: int | None = None) -> _ObsState:
    """Configure the global observability state.

    enabled:             master switch for hot-path instrumentation
    trace_capacity:      span ring size (drop-oldest past it)
    textfile:            path to (re)write the Prometheus exposition to
    textfile_interval_s: start a daemon writer rewriting ``textfile``
                         every interval (atomic rename — safe to tail)
    http_port:           serve ``/metrics`` via stdlib http.server
                         (0 = OS-assigned; read it back from
                         ``OBS.http_port``)
    """
    if enabled is not None:
        OBS.enabled = bool(enabled)
    if trace_capacity is not None:
        OBS.tracer = Tracer(trace_capacity)
    if textfile is not None:
        OBS.textfile = textfile
        if textfile_interval_s:
            _stop_writer()
            stop = threading.Event()

            def loop():
                while not stop.wait(textfile_interval_s):
                    try:
                        write_textfile(OBS.registry, textfile)
                    except Exception:              # noqa: BLE001
                        pass

            t = threading.Thread(target=loop, daemon=True,
                                 name="obs-textfile-writer")
            OBS._writer, OBS._writer_stop = t, stop
            t.start()
    if http_port is not None and OBS._http is None:
        OBS._http = start_http_server(OBS.registry, port=http_port)
    if OBS.enabled:
        # kernel launches are always counted (kernels/dispatch.py);
        # export them once enabled
        from repro_torch.obs import adapters
        adapters.bind_dispatch(OBS.registry)
    return OBS


def flush_textfile() -> str | None:
    """Write the exposition file now (regardless of the writer thread)."""
    if OBS.textfile is None:
        return None
    return write_textfile(OBS.registry, OBS.textfile)


def _stop_writer() -> None:
    if OBS._writer_stop is not None:
        OBS._writer_stop.set()
    OBS._writer = OBS._writer_stop = None


def reset() -> _ObsState:
    """Tear down exporters and return to the disabled default (tests)."""
    _stop_writer()
    if OBS._http is not None:
        try:
            OBS._http.shutdown()
        except Exception:                          # noqa: BLE001
            pass
        OBS._http = None
    OBS.enabled = False
    OBS.textfile = None
    OBS.registry = Registry()
    OBS.tracer = Tracer(DEFAULT_TRACE_CAPACITY)
    return OBS
