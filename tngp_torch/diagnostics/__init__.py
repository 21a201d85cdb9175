"""Device diagnostics of the port (counterparts of the JAX package's
device-check and stage-bench scripts)."""
