"""Fleet scale-out on one GPU: FleetDemodulator (mesh.py), ServingFleet
(serving.py) and the row packing their checkpoints share (serialize.py)."""
