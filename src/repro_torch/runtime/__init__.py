"""Control plane: macro-batch work queue."""
