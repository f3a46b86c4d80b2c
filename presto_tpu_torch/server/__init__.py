"""The coordinator HTTP server and the worker task runtime (ports of
presto_tpu/server/)."""

from presto_tpu_torch.server.http_server import PrestoTpuServer

__all__ = ["PrestoTpuServer"]
