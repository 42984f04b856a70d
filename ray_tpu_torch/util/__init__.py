"""See the module of the same name in ray_tpu (the JAX reference)."""
