"""Periodic resource sampling thread — the port of
:mod:`tpfl.management.node_monitor`.

Every ``Settings.RESOURCE_MONITOR_PERIOD`` seconds a :class:`NodeMonitor`
samples the host's CPU %, RAM % and network in / out rates, the card's
memory (through :data:`tpfl_torch.management.profiling.hbm`), the node's
contribution-ledger occupancy and the fleet gauges of
:mod:`tpfl_torch.management.fleetobs`. Readings land in the process
registry as ``tpfl_system_<metric>{node}`` gauges, under the reference's
names, and go to an optional ``report_fn(node, metric, value)`` (the web
dashboard's push path).

The reference reads the host through ``psutil``; the port reads Linux's
``/proc/stat`` (CPU time since the previous sample), ``/proc/meminfo``
(``MemAvailable`` of ``MemTotal``) and ``/proc/net/dev`` (bytes over
every interface), with the standard library only. Where a file is
missing, its metrics are not emitted.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import telemetry
from tpfl_torch.settings import Settings


def _cpu_times() -> "tuple[float, float] | None":
    """(busy, total) jiffies of all CPUs, from ``/proc/stat``."""
    try:
        with open("/proc/stat", encoding="ascii") as f:
            fields = [float(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0.0)  # idle + iowait
    total = sum(fields[:8])  # guest time is counted in user / nice already
    return total - idle, total


def _ram_percent() -> "float | None":
    """Used memory in % (total less available), from ``/proc/meminfo``."""
    try:
        info = {}
        with open("/proc/meminfo", encoding="ascii") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = float(rest.split()[0])
        total = info["MemTotal"]
        return 100.0 * (total - info["MemAvailable"]) / total
    except (OSError, ValueError, KeyError, IndexError, ZeroDivisionError):
        return None


def _net_bytes() -> "tuple[float, float] | None":
    """(bytes received, bytes sent) over every interface, from
    ``/proc/net/dev``."""
    try:
        recv = sent = 0.0
        with open("/proc/net/dev", encoding="ascii") as f:
            for line in f.readlines()[2:]:
                fields = line.partition(":")[2].split()
                recv += float(fields[0])
                sent += float(fields[8])
        return recv, sent
    except (OSError, ValueError, IndexError):
        return None


class NodeMonitor(threading.Thread):
    def __init__(self, node_addr: str,
                 report_fn: Optional[Callable[[str, str, float], None]] = None) -> None:
        super().__init__(daemon=True, name=f"node-monitor-{node_addr}")
        self._node = node_addr
        self._report = report_fn
        self._running = threading.Event()
        self._running.set()
        self._lock = make_lock("NodeMonitor._lock")
        net = _net_bytes() or (0.0, 0.0)
        # guarded-by: _lock — (bytes_recv, bytes_sent, stamp) and (busy,
        # total) CPU jiffies of the previous sample.
        self._last_net = (net[0], net[1], time.monotonic())
        self._last_cpu = _cpu_times()

    def stop(self) -> None:
        self._running.clear()

    def run(self) -> None:
        while self._running.is_set():
            try:
                self._sample()
            except Exception:
                pass
            time.sleep(Settings.RESOURCE_MONITOR_PERIOD)

    def _emit(self, metric: str, value: float) -> None:
        telemetry.metrics.gauge(f"tpfl_system_{metric}", value, labels={"node": self._node})
        if self._report is not None:
            self._report(self._node, metric, value)

    def _sample(self) -> None:
        cpu = _cpu_times()
        net = _net_bytes()
        now = time.monotonic()
        with self._lock:
            last_cpu, self._last_cpu = self._last_cpu, cpu or self._last_cpu
            last_recv, last_sent, last_t = self._last_net
            if net is not None:
                self._last_net = (net[0], net[1], now)
        if cpu is not None and last_cpu is not None:
            d_total = cpu[1] - last_cpu[1]
            self._emit("cpu_percent",
                       100.0 * (cpu[0] - last_cpu[0]) / d_total if d_total > 0 else 0.0)
        ram = _ram_percent()
        if ram is not None:
            self._emit("ram_percent", ram)
        if net is not None:
            dt = max(now - last_t, 1e-9)
            self._emit("net_in_bytes_per_s", (net[0] - last_recv) / dt)
            self._emit("net_out_bytes_per_s", (net[1] - last_sent) / dt)
        self._sample_device()
        self._sample_ledger()
        self._sample_fleet()

    def _sample_device(self) -> None:
        """Each card's allocated and peak bytes through the observatory's
        tracker (:data:`tpfl_torch.management.profiling.hbm`), which also
        keeps the ``tpfl_hbm_*`` gauges: the reference's TPU sample."""
        try:
            from tpfl_torch.management import profiling

            for dev, in_use, peak in profiling.hbm.sample():
                self._emit(f"hbm_bytes_in_use_dev{dev}", in_use)
                self._emit(f"hbm_peak_bytes_dev{dev}", peak)
        except Exception:
            pass

    def _sample_ledger(self) -> None:
        """This node's contribution-ledger occupancy and flagged count."""
        if not Settings.LEDGER_ENABLED:
            return
        try:
            from tpfl_torch.management import ledger

            stats = ledger.contrib.stats_for(self._node)
            self._emit("ledger_entries", float(stats["entries"]))
            self._emit("ledger_flagged", float(stats["flagged"]))
        except Exception:
            pass

    def _sample_fleet(self) -> None:
        """Membership-tier occupancy and population census / touched of
        every view and population registered with
        :mod:`tpfl_torch.management.fleetobs`."""
        try:
            from tpfl_torch.management import fleetobs

            fleetobs.emit_fleet_gauges(self._node)
        except Exception:
            pass


__all__ = ["NodeMonitor"]
