"""The lattices a configuration names (``"lattice": {"kind": ..., ...}``),
built by the benchmark and handed to the program and the reference alike:
one module a kind, ``<kind>.py`` with ``edges(spec)``."""

import importlib


def build(spec: dict):
    return importlib.import_module(f"benchmark.lattices.{spec['kind']}").edges(spec)
