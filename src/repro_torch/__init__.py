"""PyTorch and CUDA port of the DS-FL system in ``repro`` (the JAX
reference).  Its modules mirror the reference's layout; see README.md."""
