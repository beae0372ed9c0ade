"""The harness's general parts: files found by name, inputs made from the
seed, the drivers, the trace reduction and the comparison."""
