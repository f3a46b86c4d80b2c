"""The streaming plane: incremental view maintenance over append-log
connectors.

Port of presto_tpu/streaming/. streaming/ivm.py is the refresh engine
and connectors/stream.py the log itself; the tailing /v1/statement
cursors live in server/http_server.py."""

from presto_tpu_torch.streaming.ivm import (  # noqa: F401
    IvmRegistry,
    MaterializedView,
    ivm_unsafe_reason,
    refresh,
    shared_registry,
    shared_registry_if_exists,
    view_shape_fingerprint,
    windowed_executor,
)
