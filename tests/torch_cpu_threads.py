"""Torch's CPU threads for the port's tests, imported by each
tests/test_torch_*.py before it runs anything.

Under pytest-xdist (the Tier-1 command runs 6 workers on the host's cores)
each worker's torch takes XDIST_THREADS intra-op threads instead of one per
core: torch's OpenMP threads spin while they wait, and with every worker
holding one per core a small op waits on the others' spinning (a toy VAE
decode took 9.7 s at 8 threads against 0.16 s at 2 beside a running suite).
A run outside xdist keeps torch's default. :func:`subprocess_env` gives a
test's child process the same limit. A file whose tolerance sits at fp32's
reduction-order noise imports :func:`keep_default_threads`, which runs its
tests at torch's default count, on the sums that tolerance was set on: at
2 threads test_torch_neighborhood_attention.py's forward (2e-5 against
JAX's interpreted kernel) and test_torch_kv_split.py's split route (1e-6
against the plain version) each failed in some runs.
"""

import contextlib
import os

import pytest
import torch

XDIST_THREADS = 2
UNDER_XDIST = "PYTEST_XDIST_WORKER" in os.environ
DEFAULT_THREADS = torch.get_num_threads()

if UNDER_XDIST:
    torch.set_num_threads(min(torch.get_num_threads(), XDIST_THREADS))


def subprocess_env(**extra: str) -> dict:
    """os.environ with ``extra``, and under xdist OMP_NUM_THREADS set to
    XDIST_THREADS."""
    env = dict(os.environ, **extra)
    if UNDER_XDIST:
        env["OMP_NUM_THREADS"] = str(XDIST_THREADS)
    return env


@contextlib.contextmanager
def default_threads():
    """Torch's default thread count inside the block, the current one after."""
    current = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(current)


@pytest.fixture(scope="module", autouse=True)
def keep_default_threads():
    """Imported by a test module: its tests run at torch's default thread count."""
    with default_threads():
        yield
