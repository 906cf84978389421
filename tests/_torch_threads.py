"""Caps torch's CPU intra-op threads for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module first. The suite runs
under several pytest-xdist workers, one process each; left alone, torch
gives each process one thread per core, so the workers' threads
oversubscribe the cores and a test that takes seconds alone can take
minutes. Each process keeps its share of the cores: ``cpu_count // 6``
(the suite's six workers), at least one.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))
