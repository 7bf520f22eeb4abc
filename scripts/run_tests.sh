#!/bin/sh
# Run the test suite on a virtual 8-device CPU mesh (no GPU needed).
# The gpu-marked tests skip here; on a machine with a card,
# `python chip_smoke.py` runs them with JAX_PLATFORMS=cuda.
cd "$(dirname "$0")/.." || exit 1
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    exec python -m pytest tests/ -q "$@"
