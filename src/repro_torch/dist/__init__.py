"""Distribution subsystem of the port: so far the fault-tolerant training
loop (``fault_tolerance``).  Sharding and elasticity over several cards
are later work."""

from repro_torch.dist import fault_tolerance

__all__ = ["fault_tolerance"]
