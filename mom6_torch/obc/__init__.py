"""Open boundary conditions (counterpart of ``mom6_tpu.obc``)."""
