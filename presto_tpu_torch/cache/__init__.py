"""Persistence planes shared by the result cache and the coordinator
journal.

Port of presto_tpu/cache/ for its manifest layer only: persist.py's
generation-numbered ManifestStore, which the coordinator checkpoint
journal (dist/checkpoint.py) rides. The result cache itself — store.py,
rules.py, persist.py's CachePersister warm tier and the executor's
cache points — is ROADMAP queue 1 item 6 and not ported yet.
"""
