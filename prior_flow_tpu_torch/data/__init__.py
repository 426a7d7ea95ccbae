"""Data: flow-file and image I/O, the native host library's binding, the
datasets with their augmentors, the batch loader and the training-stage
and config-driven factories."""
