"""REST client of the web dashboard and the Prometheus metrics endpoint —
the port of :mod:`tpfl.management.web_services`, on the standard
library's ``urllib`` and ``http.server``.

:class:`TpflWebServices` pushes node registration, logs and local /
global / system metrics to a dashboard with ``x-api-key`` auth; a failed
request is dropped (observability never takes a node down).

:class:`MetricsHTTPServer` is the pull side: the process registry
(:mod:`tpfl_torch.management.telemetry`) as Prometheus text at
``/metrics`` and as JSON at ``/metrics.json``; ``/fleet.json`` serves the
merged cross-process view (every ``fleetsnap-*.json`` of the fleet
directory folded by :func:`tpfl_torch.management.fleetobs.fleet_from_dir`,
``origin=<rank>`` labels intact) and ``/healthz`` answers 200 / 503 from
the attached :class:`~tpfl_torch.management.fleetobs.SLOWatchdog`.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Optional

from tpfl_torch.management import telemetry


class TpflWebServices:
    """Client of a tpfl-style web dashboard."""

    def __init__(self, url: str, key: str) -> None:
        self._url = url.rstrip("/")
        self._key = key
        self._node_sessions: dict[str, Any] = {}

    # --- low-level ---

    def _post(self, path: str, payload: dict) -> dict | None:
        req = urllib.request.Request(
            f"{self._url}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", "x-api-key": self._key},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                body = resp.read()
                return json.loads(body) if body else {}
        except (urllib.error.URLError, OSError, ValueError):
            return None

    # --- API ---

    def register_node(self, node: str, is_simulated: bool) -> None:
        resp = self._post(
            "/node", {"address": node, "is_simulated": is_simulated}
        )
        if resp is not None:
            self._node_sessions[node] = resp.get("session_id")

    def unregister_node(self, node: str) -> None:
        self._post("/node/unregister", {"address": node})

    def send_log(self, time: str, node: str, level: str, message: str) -> None:
        self._post(
            "/node-log",
            {"time": time, "address": node, "level": level, "message": message},
        )

    def send_local_metric(
        self, node: str, metric: str, value: float, step: int, round: int
    ) -> None:
        self._post(
            "/node-metric/local",
            {
                "address": node,
                "metric": metric,
                "value": value,
                "step": step,
                "round": round,
            },
        )

    def send_global_metric(
        self, node: str, metric: str, value: float, round: int
    ) -> None:
        self._post(
            "/node-metric/global",
            {"address": node, "metric": metric, "value": value, "round": round},
        )

    def send_system_metric(
        self, node: str, metric: str, value: float, time: str
    ) -> None:
        self._post(
            "/node-metric/system",
            {"address": node, "metric": metric, "value": value, "time": time},
        )


class MetricsHTTPServer:
    """Prometheus / JSON exposition of the process metrics registry.

    ``start()`` binds on loopback (port 0: an ephemeral one, returned and
    kept on ``self.port``) and serves on a named daemon thread; ``stop()``
    shuts it down. One per process: the registry is process-wide, so one
    endpoint covers every in-process node."""

    def __init__(
        self,
        port: int = 0,
        registry: "telemetry.MetricsRegistry | None" = None,
        watchdog: "Any | None" = None,
        fleet_dir: "str | None" = None,
    ) -> None:
        self._registry = registry if registry is not None else telemetry.metrics
        self._port = port
        self._watchdog = watchdog
        self._fleet_dir = fleet_dir
        self._httpd: Optional[HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: int = 0

    def start(self) -> int:
        registry = self._registry
        watchdog = self._watchdog
        fleet_dir = self._fleet_dir

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                status = 200
                if self.path.startswith("/metrics.json"):
                    body = registry.dump_json().encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/fleet.json"):
                    # Folded at GET time: as fresh as the last snapshots.
                    from tpfl_torch.management import fleetobs

                    body = fleetobs.fleet_from_dir(fleet_dir).dump_json(
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/healthz"):
                    verdicts = (
                        watchdog.verdicts() if watchdog is not None else []
                    )
                    healthy = watchdog.healthy() if watchdog else True
                    status = 200 if healthy else 503
                    body = json.dumps(
                        {"healthy": healthy, "targets": verdicts},
                        sort_keys=True,
                    ).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:  # quiet
                pass

        self._httpd = HTTPServer(("127.0.0.1", self._port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name=f"tpfl-metrics-http-{self.port}",
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
