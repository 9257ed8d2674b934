"""CUDA kernels of the port (``csrc/``), their wrappers and plain PyTorch
versions.  Importing this package compiles nothing: the kernels build at
their first launch (:mod:`.build`)."""
