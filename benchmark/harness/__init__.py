"""The benchmark's own code: read simulation, the paced read source, the
operation counts, the profiler reduction and the output comparison."""
