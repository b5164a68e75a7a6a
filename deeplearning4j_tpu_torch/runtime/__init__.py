"""Runtime of the port: the CUDA-graph executable store (`executables`)
and the batch prefetch that feeds it (`pipeline`)."""
