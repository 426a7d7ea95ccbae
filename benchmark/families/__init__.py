"""Model families: how the benchmark builds the program's model of a
configuration, and which frozen reference and counts go with it."""
