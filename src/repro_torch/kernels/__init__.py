"""Hand-written CUDA kernels of the port (``csrc/``) and their wrappers.

Importing this package builds nothing: a kernel is compiled the first time
a wrapper launches it on a CUDA tensor (see `_build`)."""
