"""App-level host modules of the port (the JAX package's ``app``): the
XOR-schedule routing table of ``calibration``, the proposer's DAH of
``proposal``, and the state machine's ``context``, ``errors`` and ``ante``.
The App itself is not ported yet."""
