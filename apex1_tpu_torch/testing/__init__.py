"""Serving drill fixtures of the port: `chaos` (serving faults and the
toy decoder) and `fleetsim` (the virtual-clock fleet simulator)."""
