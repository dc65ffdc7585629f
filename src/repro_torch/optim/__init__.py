"""Functional optimizers over flat tensor dicts, and learning-rate
schedules."""
from .optimizers import adam, momentum, sgd  # noqa
from .schedules import constant, cosine, linear_warmup  # noqa
