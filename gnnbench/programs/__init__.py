"""The program's model of each family, built by name:
``gnnbench/programs/<family>.py``, a function ``build(cfg, device)``."""

import importlib


def build(cfg, device):
    """The port's model of ``cfg``'s family, at ``cfg``'s widths."""
    return importlib.import_module(f"gnnbench.programs.{cfg['model']['family']}").build(cfg, device)
