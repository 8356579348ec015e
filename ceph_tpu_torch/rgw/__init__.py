"""RGW-lite: S3-style HTTP object gateway over the librados subset.

The thin vertical slice of the reference gateway (src/rgw/: beast/asio
HTTP frontend rgw_asio_frontend.cc, process_request rgw_process.cc:265,
RADOS store driver src/rgw/driver/rados/): buckets and objects over
RADOS pools, with the bucket index kept in omap like the reference's
bucket index objects (cls_rgw).
"""
from ceph_tpu_torch.rgw.gateway import RGWGateway

__all__ = ["RGWGateway"]
