"""Regression tables of the port at the flight rates: jax-free copies of
the capture functions and sweeps of tools/per_table.py and
tools/robustness_table.py, held to the JAX package's committed goldens
(tests/golden/)."""
import json
import os

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")


def load_golden(name: str) -> dict:
    """tests/golden/<name>.json (a table the JAX package committed)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)
