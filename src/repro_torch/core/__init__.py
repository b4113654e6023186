"""Core A-FADMM library of the port: complex planes, channel, power
control, transport, the ADMM round and the algorithm object."""
