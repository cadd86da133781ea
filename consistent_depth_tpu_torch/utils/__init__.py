"""Host-side helpers of the port: frame ranges and pair sampling."""
