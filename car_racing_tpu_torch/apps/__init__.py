"""Command-line drivers of the port (car_racing_tpu/apps)."""
