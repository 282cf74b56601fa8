"""The server role's device side: the serving pipeline over the set executor.

Counterpart of `pinot_tpu/cluster/device_server.py`. The HTTP server role and
the rest of the cluster are not ported.
"""

from .device_server import DeviceQueryPipeline

__all__ = ["DeviceQueryPipeline"]
