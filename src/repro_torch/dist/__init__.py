"""Distribution subsystem of the port.

  sharding         logical-axis rules -> placements on a DeviceMesh, and
                   the statistics reduction of the sharded EM step
  fault_tolerance  checkpoint-restart training loop + straggler detection
  elastic          re-place state on a grown or shrunk mesh
"""

from repro_torch.dist import elastic, fault_tolerance, sharding

__all__ = ["elastic", "fault_tolerance", "sharding"]
