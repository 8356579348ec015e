"""Process-wide device offload service: dynamic batching for the EC data
path (see service.py for the design notes)."""
from ceph_tpu_torch.offload.service import (OFFLOAD_OPTIONS, OffloadService,
                                            get_service,
                                            get_service_or_none,
                                            register_config, service_for,
                                            set_enabled)

__all__ = ["OFFLOAD_OPTIONS", "OffloadService", "get_service",
           "get_service_or_none", "register_config", "service_for",
           "set_enabled"]
