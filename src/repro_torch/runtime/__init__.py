"""Runtime of the port's training driver: the restarting step loop, the
heartbeat monitor and failure injection (``fault_tolerance``)."""
