"""Fleet scale-out: FleetDemodulator on one device or over a device list
(mesh.py), ServingFleet (serving.py), the row packing their checkpoints
share (serialize.py), one stream's FIR split along time (timeshard.py) and
one fleet over several processes (multihost.py)."""
