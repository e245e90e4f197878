"""Table I/O of the port."""
