"""Host utilities: input padding, the warm-start splat, flow colouring."""
