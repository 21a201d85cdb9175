"""The program under test, built from a configuration file (one module per arch)."""
