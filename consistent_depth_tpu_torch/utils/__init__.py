"""Host-side helpers of the port: frame ranges and pair sampling, and the
spans of :mod:`.tracing`."""
