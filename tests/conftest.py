"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's CI strategy (SURVEY §4): numerics are validated
against the numpy oracle on CPU; TPU-specific behavior is exercised by
bench.py / __graft_entry__.py on real hardware.
"""

import os

# must be set before the CPU backend initializes
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow tests")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="need --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc and triton; skips without one")
