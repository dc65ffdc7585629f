"""Federated protocol core: losses, aggregation, client loops, the DS-FL
algorithm and the engine."""
