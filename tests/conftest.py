"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh BEFORE jax import so that
multi-device sharding logic is exercised without accelerator hardware
(SURVEY.md §4). The GPU path is exercised by ``python3 chip_smoke.py`` on
the card.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # tests always run on the CPU mesh
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# select the CPU backend through the config API as well, which wins over
# any platform a site configuration sets before this file runs
jax.config.update("jax_platforms", "cpu")
# float64 available for parity/oracle tests (production code passes explicit
# float32 dtypes everywhere, so this only widens where tests ask for it)
jax.config.update("jax_enable_x64", True)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# Shims directory: stand-ins for optional deps of the *reference* package
# (pvlib, ...) so golden-parity tests can execute the actual reference code.
SHIMS = os.path.join(REPO_ROOT, "tests", "_shims")
REFERENCE_ROOT = "/root/reference"


def add_reference_to_path() -> bool:
    """Makes the reference sustaingym package importable (with shims).

    Returns False when the reference tree is unavailable (tests should then
    fall back to recorded golden files).
    """
    if not os.path.isdir(os.path.join(REFERENCE_ROOT, "sustaingym")):
        return False
    if SHIMS not in sys.path:
        sys.path.insert(0, SHIMS)
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    return True
