"""Host-side framework of the port: parameters, messages, clocks,
reproducing sums and restarts."""
