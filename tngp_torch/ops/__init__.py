"""Plain tensor ops of the render and training paths (counterparts of `tngp/ops/`)."""
