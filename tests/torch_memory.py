"""The port's memory connector, under the name the port's tests import
it by (presto_tpu_torch/connectors/memory.py)."""

from presto_tpu_torch.connectors.memory import MemoryConnector

__all__ = ["MemoryConnector"]
