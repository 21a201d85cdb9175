"""Plain tensor ops of the eval path (counterparts of `tngp/ops/`)."""
