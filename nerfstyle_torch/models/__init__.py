"""Neural field models of the port."""
