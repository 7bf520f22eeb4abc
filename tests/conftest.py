"""Test config: run on a virtual 8-device CPU mesh so sharding tests work
anywhere. Mirrors the reference's CPU/GPU duality testing with mesh-shape
duality (SURVEY.md §4).

JAX is pinned to the CPU only when JAX_PLATFORMS is unset: the
`gpu`-marked tests run on the card with JAX_PLATFORMS=cuda
(`python chip_smoke.py` does that first)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# env alone loses if JAX was imported before this file; the config wins
# while no backend is initialized
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

FIXTURE_SCENES = Path(__file__).resolve().parent / "fixtures" / "scenes"


def fixture_scene(name: str) -> Path:
    """Path of a generated configuration scene (tests/fixtures/scenes)."""
    return FIXTURE_SCENES / f"{name}.json"


def env_substitutes(width: int = 128, height: int = 64) -> dict:
    """texture_substitutes mapping the fixtures' environment texture to a
    generated map of the given size."""
    from ignis_tpu.scene.fixtures import ENV_TEXTURE
    from ignis_tpu.utils.envgen import ensure_substitute_env
    return {ENV_TEXTURE: str(ensure_substitute_env(width, height))}


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    import jax
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda on "
                    "the card; python chip_smoke.py does)")
