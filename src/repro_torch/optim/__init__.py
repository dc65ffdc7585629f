"""Functional optimizers over flat tensor dicts."""
