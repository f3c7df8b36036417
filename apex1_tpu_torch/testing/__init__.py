"""Drill fixtures of the port: `chaos` (training, checkpoint and serving
faults, the toy decoder) and `fleetsim` (the virtual-clock fleet
simulator)."""
