"""Host utilities: input padding, the warm-start splat, flow colouring,
metric logging and profiling hooks."""
