"""The distributed paths (port of presto_tpu/dist): exchange insertion
and fragmentation, the in-process mesh executor and its ICI exchange
plane, plan and page serde, the spooled-exchange data plane, the stage
scheduler and the DCN coordinator."""

from presto_tpu_torch.dist.executor import DistExecutor, make_mesh

__all__ = ["DistExecutor", "make_mesh"]
