"""Pipeline stages of the port (the flow stage in this slice)."""
