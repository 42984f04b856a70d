"""Command-line tools of the port (counterpart of `ray_tpu/scripts`)."""
