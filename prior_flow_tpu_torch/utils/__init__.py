"""Host utilities: input padding, the warm-start splat, flow colouring,
metric logging, profiling hooks and the precision scope."""
