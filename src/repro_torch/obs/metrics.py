"""repro_torch.obs.metrics — the serving metrics registry.

Counters / gauges / histograms with label sets, one :class:`Registry`
behind all of them, and a Prometheus text-exposition writer with a
parser, so the tests read the exact bytes an external scraper would.
Stdlib only; a copy of the JAX package's ``obs/metrics.py``, so both
packages expose one format.

Two ways data gets in:

* **push** — the serving hot path calls ``counter.inc`` /
  ``histogram.observe`` directly (only when ``repro_torch.obs`` is
  enabled).
* **pull** — ``Registry.register_collector(fn)`` registers a scrape-time
  callback that refreshes gauges from live objects (queue depths,
  ``EngineState`` telemetry); collectors run inside
  ``collect()``/``render()``, never on the request path.

Export: :func:`write_textfile` (atomic tmp+rename, so a scraper never
reads a half-written file) and :func:`start_http_server` (stdlib
``http.server`` on a daemon thread).
"""
from __future__ import annotations

import os
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "render_prometheus", "parse_prometheus", "write_textfile",
           "start_http_server", "LATENCY_BUCKETS_MS"]

#: default histogram edges for request latency in milliseconds
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Family:
    """One named metric family: a map labelvalues -> value."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> list:
        """[(suffix, labels dict, value), ...] — exposition order."""
        with self._lock:
            items = sorted(self._values.items())
        out = []
        for key, v in items:
            out.append(("", dict(zip(self.labelnames, key)), v))
        return out

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Family):
    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + v

    def set_total(self, v: float, **labels) -> None:
        """Adopt an externally-maintained monotonic total (the pull
        adapters mirror existing counters — scheduler ``counters``,
        ``trace_counts`` — instead of double-counting them)."""
        k = self._key(labels)
        with self._lock:
            self._values[k] = float(v)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class Gauge(_Family):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = float(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + v

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))


class _HistValue:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)     # +1 for +Inf
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(LATENCY_BUCKETS_MS if buckets is None
                         else buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b

    def observe(self, v: float, **labels) -> None:
        k = self._key(labels)
        v = float(v)
        with self._lock:
            h = self._values.get(k)
            if h is None:
                h = self._values[k] = _HistValue(len(self.buckets))
            i = len(self.buckets)
            for j, le in enumerate(self.buckets):
                if v <= le:
                    i = j
                    break
            h.counts[i] += 1
            h.sum += v
            h.count += 1

    def percentile(self, q: float, **labels) -> float | None:
        """Estimated q-th percentile (0..100) from the bucket counts —
        the single estimator :mod:`tools.dartop` also uses (via
        :func:`estimate_percentile`)."""
        k = self._key(labels)
        with self._lock:
            h = self._values.get(k)
            if h is None or not h.count:
                return None
            counts = list(h.counts)
        return estimate_percentile(self.buckets, counts, q)

    def samples(self) -> list:
        with self._lock:
            items = sorted(self._values.items())
        out = []
        for key, h in items:
            labels = dict(zip(self.labelnames, key))
            cum = 0
            for le, c in zip(self.buckets, h.counts):
                cum += c
                out.append(("_bucket", {**labels, "le": _fmt(le)}, cum))
            out.append(("_bucket", {**labels, "le": "+Inf"}, h.count))
            out.append(("_sum", labels, h.sum))
            out.append(("_count", labels, h.count))
        return out


def estimate_percentile(buckets, counts, q: float) -> float:
    """q-th percentile (0..100) from per-bucket (non-cumulative) counts
    via linear interpolation inside the winning bucket.  ``counts`` has
    ``len(buckets) + 1`` entries (last = overflow past the top edge,
    credited at the top edge — an explicit floor, not an estimate)."""
    total = sum(counts)
    if not total:
        return 0.0
    target = (q / 100.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= target and c:
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            lo = buckets[i - 1] if 0 < i <= len(buckets) else 0.0
            frac = (target - prev) / c
            return lo + frac * (hi - lo)
    return float(buckets[-1])


class Registry:
    """Get-or-create factory + scrape surface for metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._collectors: list = []

    # -- family factories (idempotent; type/labels must agree) ----------
    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, labelnames,
                                                 **kw)
                return fam
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind} with labels "
                f"{tuple(labelnames)} (was {fam.kind} {fam.labelnames})")
        return fam

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets)

    def get(self, name) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    # -- pull-side collectors -------------------------------------------
    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs at every scrape, BEFORE the families
        are read — refresh gauges from live objects there.  A collector
        that raises is dropped (a dead server must not poison the whole
        scrape) ; one that returns the string ``"dead"`` unregisters
        itself quietly (weakref-bound adapters)."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> list[_Family]:
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn(self) == "dead":
                    dead.append(fn)
            except Exception:                      # noqa: BLE001
                dead.append(fn)
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def render(self) -> str:
        return render_prometheus(self)


def render_prometheus(registry: Registry) -> str:
    """Prometheus text exposition format, version 0.0.4."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for suffix, labels, value in fam.samples():
            if labels:
                lab = ",".join(
                    f'{k}="{_escape_label(str(v))}"'
                    for k, v in labels.items())
                lines.append(f"{fam.name}{suffix}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{fam.name}{suffix} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# parsing (the dashboard + the round-trip tests read what we wrote)
# ---------------------------------------------------------------------------

def _parse_labels(s: str) -> dict:
    out, i = {}, 0
    while i < len(s):
        while i < len(s) and s[i] in ", ":
            i += 1
        if i >= len(s):
            break
        eq = s.index("=", i)
        name = s[i:eq].strip()
        if s[eq + 1] != '"':
            raise ValueError(f"unquoted label value in {s!r}")
        j, buf = eq + 2, []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                buf.append(s[j])
                j += 1
        out[name] = "".join(buf)
        i = j + 1
    return out


def parse_prometheus(text: str) -> dict:
    """text -> {family: {"type", "help", "samples": [(name, labels,
    value), ...]}}.  Histogram series (``_bucket``/``_sum``/``_count``)
    attach to their base family."""
    families: dict = {}
    order: list = []

    def fam_for(sample_name: str) -> dict:
        for base in order[::-1]:
            if sample_name == base or (
                    families[base]["type"] == "histogram"
                    and sample_name in (base + "_bucket", base + "_sum",
                                        base + "_count")):
                return families[base]
        f = families.setdefault(
            sample_name, {"type": "untyped", "help": "", "samples": []})
        if sample_name not in order:
            order.append(sample_name)
        return f

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            f = families.setdefault(
                name, {"type": "untyped", "help": "", "samples": []})
            f["help"] = help_.replace("\\n", "\n").replace("\\\\", "\\")
            if name not in order:
                order.append(name)
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            f = families.setdefault(
                name, {"type": "untyped", "help": "", "samples": []})
            f["type"] = kind.strip()
            if name not in order:
                order.append(name)
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            labels_s = rest[:rest.rindex("}")]
            value_s = rest[rest.rindex("}") + 1:].strip()
            labels = _parse_labels(labels_s)
        else:
            name, _, value_s = line.partition(" ")
            labels = {}
        fam_for(name)["samples"].append(
            (name, labels, float(value_s.replace("+Inf", "inf"))))
    return families


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def write_textfile(registry: Registry, path: str) -> str:
    """Atomically (re)write the exposition file a node-exporter-style
    scraper or ``tools/dartop.py --file`` tails."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(render_prometheus(registry))
    os.replace(tmp, path)
    return path


def start_http_server(registry: Registry, port: int = 0,
                      addr: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (and ``/``) from a daemon thread; returns
    the ``http.server`` instance (``.server_address[1]`` is the bound
    port — pass ``port=0`` to let the OS pick; ``.shutdown()`` stops
    it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                          # noqa: N802
            body = render_prometheus(registry).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                 # quiet by default
            pass

    srv = ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="obs-metrics-http")
    t.start()
    return srv
