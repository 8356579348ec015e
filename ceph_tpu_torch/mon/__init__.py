"""Monitor: cluster control plane.

Re-creation of the reference's src/mon/: a quorum of monitor daemons runs
single-Paxos (collect/begin/accept/commit/lease, src/mon/Paxos.cc) over a
versioned store, with PaxosServices batching state changes into proposed
transactions (src/mon/PaxosService.cc). The OSDMonitor service owns the
OSDMap: EC profiles and pools are validated in-monitor by instantiating
the plugin (OSDMonitor.cc:7506), osd boots and failure reports become
map incrementals, and committed epochs are pushed to subscribers.

  store       MonitorDBStore-lite: prefixed KV + atomic transactions,
              JSON-file persistence
  paxos       elections + collect/begin/accept/commit/lease over the
              messenger
  monitor     Monitor daemon + OSDMonitor service + subscriptions
  mon_client  MonClient: bootstrap, subscriptions, commands

The port's copy of ceph_tpu/mon/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.mon.store import MonStore
from ceph_tpu_torch.mon.monitor import Monitor, MonMap
from ceph_tpu_torch.mon.mon_client import MonClient

__all__ = ["MonStore", "Monitor", "MonMap", "MonClient"]
