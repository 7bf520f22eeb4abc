"""Content-addressed asset cache (CacheManager + serialization analog).

The reference caches converted assets (parsed meshes, built BVHs) under a
SHA256 key so repeated scene loads skip the expensive conversion
(/root/reference/src/runtime/CacheManager.h:18-27, SHA256.cpp, and the
binary mesh/BVH serializers under src/runtime/serialization/). Here the
converted artifacts are numpy arrays, so the serialization tier collapses
to .npz files keyed by a content hash:

- ``cached_mesh(path, loader, variant)``: hash(file bytes + variant) ->
  {vertices, indices, normals, uvs}.
- ``cached_arrays(key_parts, builder)``: hash of raw input buffers ->
  arbitrary named-array dict (used for built BVHs).

Disabled unless IGNIS_CACHE_DIR is set or ``enable()`` is called —
scene loads must stay deterministic for tests that patch loaders.

``checkout_dir(name)`` is the one place the package keeps generated
files: a fixed directory under ``<checkout>/.cache`` (listed in
.gitignore), so nothing is written outside the checkout.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

_FORMAT_VERSION = "1"  # bump to invalidate every cached artifact
_enabled_dir: Optional[Path] = None
CHECKOUT = Path(__file__).resolve().parents[2]


def checkout_dir(name: str) -> Path:
    """<checkout>/.cache/<name>, created on first use."""
    d = CHECKOUT / ".cache" / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def cache_dir() -> Optional[Path]:
    if _enabled_dir is not None:
        return _enabled_dir
    d = os.environ.get("IGNIS_CACHE_DIR")
    return Path(d) if d else None


def enable(path=None) -> Path:
    """Turn the cache on for this process (defaults to
    <checkout>/.cache/assets)."""
    global _enabled_dir
    _enabled_dir = Path(path) if path else checkout_dir("assets")
    _enabled_dir.mkdir(parents=True, exist_ok=True)
    return _enabled_dir


def disable():
    global _enabled_dir
    _enabled_dir = None


def _hash_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _load_npz(f: Path) -> Optional[Dict[str, np.ndarray]]:
    try:
        with np.load(f, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        try:
            f.unlink()  # corrupt/truncated entry: drop it
        except OSError:
            pass
        return None


def _store_npz(f: Path, arrays: Dict[str, np.ndarray]):
    # np.savez appends ".npz" unless the name already ends with it
    tmp = f.with_name(f.stem + ".tmp-%d.npz" % os.getpid())
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, f)
    except OSError:
        try:
            tmp.unlink()
        except OSError:
            pass


def cached_mesh(path, loader: Callable[[], "object"], variant: str = ""):
    """Run ``loader()`` (returning a TriMesh) through the cache.

    Key = sha256(file bytes) + variant (e.g. shape_index). The parsed
    TriMesh's canonical arrays are serialized; normals/uvs may be absent.
    """
    d = cache_dir()
    if d is None:
        return loader()
    d.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(
        (_FORMAT_VERSION + "|mesh|" + _hash_file(path) + "|" + variant)
        .encode()).hexdigest()
    f = d / f"mesh_{key}.npz"
    if f.exists():
        z = _load_npz(f)
        if z is not None:
            from ..scene.mesh import TriMesh
            return TriMesh(
                z["vertices"], z["indices"],
                z["normals"] if z["normals"].size else None,
                z["uvs"] if z["uvs"].size else None)
    m = loader()
    _store_npz(f, {
        "vertices": np.asarray(m.vertices, np.float32),
        "indices": np.asarray(m.indices, np.int32),
        "normals": (np.asarray(m.normals, np.float32)
                    if m.normals is not None else np.zeros((0, 3), np.float32)),
        "uvs": (np.asarray(m.texcoords, np.float32)
                if m.texcoords is not None else np.zeros((0, 2), np.float32)),
    })
    return m


def cached_arrays(tag: str, key_parts, builder: Callable[[], Dict[str, np.ndarray]]):
    """Generic content-addressed array-dict cache (built BVHs etc.).

    ``key_parts``: iterable of ndarrays/bytes/str hashed into the key.
    ``builder()`` -> {name: ndarray}. Returns the (possibly cached) dict.
    """
    d = cache_dir()
    if d is None:
        return builder()
    d.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256((_FORMAT_VERSION + "|" + tag).encode())
    for p in key_parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(str(p).encode())
    f = d / f"{tag}_{h.hexdigest()}.npz"
    if f.exists():
        z = _load_npz(f)
        if z is not None:
            return z
    out = builder()
    _store_npz(f, out)
    return out
