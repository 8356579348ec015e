"""CephFS layer: MDS daemon (metadata in RADOS) + POSIX-ish client."""
from ceph_tpu_torch.mds.daemon import MDSDaemon
from ceph_tpu_torch.mds.client import CephFS, CephFSError, File

__all__ = ["MDSDaemon", "CephFS", "CephFSError", "File"]
