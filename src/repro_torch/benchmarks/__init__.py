"""Torch twins of the paper's figure benchmarks (``benchmarks/`` at the root
of the repo): the same tasks, algorithms, round budgets and derived numbers,
on the card by default.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig2a
"""
