"""File I/O of the port."""
