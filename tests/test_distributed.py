"""Multi-host layer test: two real OS processes form a jax.distributed
group over a TCP coordinator (CPU backend, 2 virtual devices each = 4
global), render the same scene with lanes sharded over the global mesh,
and must produce identical full films locally via the replicated-output
all-gather. This is the closest single-machine analog of two hosts of
cards (SURVEY.md §2e distributed backend row)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from ignis_tpu.parallel import distributed as dist

dist.initialize(coordinator={coord!r}, num_processes=2,
                process_id={pid})
import jax
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())

import ignis_tpu
SCENE = {scene!r}
rt = ignis_tpu.loadFromString(SCENE, spi=2)
mesh = dist.global_mesh()
film = dist.render_distributed(rt.scene, rt.settings, mesh, 0, 0)
target = np.zeros_like(film)
import jax.numpy as jnp
loss, _ = dist.train_step_distributed(rt.scene, rt.settings,
                                      jnp.asarray(target), 0, 0, 1e-2, mesh)
print("RESULT", json.dumps({{"pid": {pid}, "mean": float(film.mean()),
                             "shape": list(film.shape),
                             "loss": float(loss)}}))
"""

SCENE = json.dumps({
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [16, 16]},
    "bsdfs": [{"type": "diffuse", "name": "g",
               "reflectance": [0.6, 0.5, 0.4]}],
    "shapes": [{"type": "rectangle", "name": "B", "width": 4, "height": 4}],
    "entities": [{"name": "B", "shape": "B", "bsdf": "g"}],
    "lights": [{"type": "point", "name": "P", "position": [0, 1, -1.5],
                "intensity": [6, 6, 6]}],
})


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_distributed_render():
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = []
    for pid in range(2):
        code = WORKER.format(repo=str(REPO), coord=coord, pid=pid,
                             scene=SCENE)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append(json.loads(line[len("RESULT "):]))
    assert results[0]["shape"] == [16, 16, 3]
    # both processes hold the identical full film and loss
    assert results[0]["mean"] == pytest.approx(results[1]["mean"], rel=1e-6)
    assert results[0]["loss"] == pytest.approx(results[1]["loss"], rel=1e-6)
    assert results[0]["mean"] > 0.0
