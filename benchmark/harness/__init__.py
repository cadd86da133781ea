"""The benchmark's harness: traffic, weights, the run of a cell, the
roofline arithmetic and the trace reader."""
