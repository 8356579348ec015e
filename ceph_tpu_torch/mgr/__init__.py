"""Mgr-lite: the monitoring/metrics plane.

The reference mgr daemon's most-load-bearing module is the prometheus
exporter (src/pybind/mgr/prometheus/module.py); this package provides
its analog: an HTTP endpoint exposing every PerfCounters metric in the
process plus cluster health, in the prometheus text format. The port's
copy of ceph_tpu/mgr: the daemon with its modules (balancer, PG
autoscaler), the report fan-in index whose device rows carry each
OSD's per-card offload counters, the exporter and the metrics history.
"""
from ceph_tpu_torch.mgr.exporter import MetricsExporter
from ceph_tpu_torch.mgr.daemon import (BalancerModule, DaemonStateIndex,
                                       MgrDaemon, MgrModule,
                                       PGAutoscalerModule)
from ceph_tpu_torch.mgr.mgr_client import MgrClient

__all__ = ["MetricsExporter", "MgrDaemon", "MgrModule", "MgrClient",
           "DaemonStateIndex", "BalancerModule", "PGAutoscalerModule"]
