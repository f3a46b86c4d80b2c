"""The worker task runtime (port of presto_tpu/server/worker.py)."""
