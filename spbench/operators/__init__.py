"""The benchmark's own generators of operators and coefficient fields.

They make triples on the device from sizes and a seed, without the port:
the port and the plain reference are both handed what they make."""

import importlib


def generator(config):
    """The generator module that ``config["generator"]`` names."""
    return importlib.import_module(f"spbench.operators.{config['generator']}")
