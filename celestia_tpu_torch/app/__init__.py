"""App-level host modules of the port (the JAX package's ``app``): so far
only the XOR-schedule routing table of ``calibration``."""
