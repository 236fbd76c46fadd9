"""The benchmark harness of the port: specification, program adapter, seeded inputs, traces."""
