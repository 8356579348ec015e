"""Mgr-lite: the monitoring/metrics plane.

The port carries the daemons' side of it so far: `MgrClient`, the
MMgrReport session every daemon runs (mgr_client.py). The mgr daemon,
its exporter and its history follow with the cluster benchmarks.
"""
from ceph_tpu_torch.mgr.mgr_client import MgrClient

__all__ = ["MgrClient"]
