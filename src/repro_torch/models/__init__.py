"""Functional models over flat tensor dicts."""
