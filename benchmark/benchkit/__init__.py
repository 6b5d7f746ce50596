"""The benchmark's own code: what every cell shares (the spec, the traffic
generator, the peaks, the profiler's reduction, the import guard)."""
