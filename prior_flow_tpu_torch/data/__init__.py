"""Data: flow-file and image I/O, the native host library's binding, and
the datasets' index builders and sample readers. The augmentors, the
batch loader and the training-stage factory are not ported yet."""
