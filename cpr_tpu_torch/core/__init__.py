"""Core substrates of the port (the block DAG)."""
