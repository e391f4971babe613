"""Command-line drivers: ``python -m instancediff_torch.tools.restore`` and
``python -m instancediff_torch.tools.testUM``."""
