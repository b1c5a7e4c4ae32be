"""The harness: cells by name (spec), the timed window (window), the device
trace (trace), the work counts behind the rooflines (work), and the check
that decides ``correct`` (check)."""
