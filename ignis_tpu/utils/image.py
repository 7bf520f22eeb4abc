"""Image IO: EXR / HDR / PNG / JPG read+write.

Parity target: reference Image IO (/root/reference/src/runtime/Image.cpp —
tinyexr for EXR, stb for LDR/HDR). Here: EXR is read and written by the
package's own code (utils/exr.py reader, the ZIP scanline writer below);
OpenCV, when installed, handles the LDR and .hdr formats. Gamma handling
matches the reference (LDR input is srgb-decoded to linear; EXR is linear).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np



def _cv2(path):
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"{Path(path).suffix or path}: reading or writing this format "
            "needs OpenCV (cv2), which is not installed; EXR needs nothing "
            "beyond numpy") from None
    return cv2


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def load_image(path, linear: bool = False) -> np.ndarray:
    """Load as linear float32 [h, w, 3] (RGB). `linear=True` skips the
    sRGB decode for data images (normal maps etc., ImagePattern 'linear'
    flag)."""
    path = str(path)
    if Path(path).suffix.lower() == ".exr":
        from .exr import load_exr_rgb
        return np.ascontiguousarray(load_exr_rgb(path), np.float32)
    cv2 = _cv2(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH
                     | cv2.IMREAD_ANYCOLOR)
    if img is None:
        raise IOError(f"Cannot load image {path}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    # OpenCV loads BGR
    img = img[..., ::-1].astype(np.float32)
    suffix = Path(path).suffix.lower()
    if suffix in (".png", ".jpg", ".jpeg", ".bmp", ".tga"):
        maxv = 255.0 if img.max() > 1.5 else 1.0
        if img.dtype != np.float32 or maxv > 1.0:
            img = img / maxv
        if not linear:
            img = srgb_to_linear(img).astype(np.float32)
    return np.ascontiguousarray(img, np.float32)


def save_image(path, img: np.ndarray):
    """Save linear float32 [h, w, 3] RGB. EXR/HDR keep linear; LDR formats
    are gamma-encoded."""
    path = str(path)
    img = np.asarray(img, np.float32)
    suffix = Path(path).suffix.lower()
    if suffix == ".exr":
        write_exr(path, img)
        return
    cv2 = _cv2(path)
    if suffix == ".hdr":
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
    else:
        ldr = (linear_to_srgb(img) * 255.0 + 0.5).astype(np.uint8)
        cv2.imwrite(path, np.ascontiguousarray(ldr[..., ::-1]))


def write_exr_multilayer(path, layers, metadata=None):
    """Scanline ZIP EXR with multiple RGB layers + ig* metadata attributes
    (reference Image.cpp:975 / Runtime::saveFramebuffer layer naming:
    default layer channels R/G/B, AOV layers Name.R/Name.G/Name.B).

    layers: dict name -> [h, w, 3] float array ("" = default layer)
    metadata: dict name -> str | int | float | (x, y, z)
    """
    first = next(iter(layers.values()))
    h, w = first.shape[0], first.shape[1]
    channels = []
    for lname, img in layers.items():
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        prefix = f"{lname}." if lname else ""
        channels += [(prefix + "B", img[..., 2]), (prefix + "G", img[..., 1]),
                     (prefix + "R", img[..., 0])]
    channels.sort(key=lambda c: c[0])  # EXR requires sorted channel names

    def attr(name, type_, data):
        return (name.encode() + b"\0" + type_.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    meta_attrs = b""
    for name, value in (metadata or {}).items():
        if isinstance(value, str):
            meta_attrs += attr(name, "string", value.encode())
        elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
            meta_attrs += attr(name, "int", struct.pack("<i", int(value)))
        elif isinstance(value, (float, np.floating)):
            meta_attrs += attr(name, "float", struct.pack("<f", float(value)))
        elif isinstance(value, (tuple, list, np.ndarray)) and len(value) == 3:
            meta_attrs += attr(name, "v3f",
                               struct.pack("<fff", *[float(x) for x in value]))
    _write_exr_channels(path, w, h, channels, meta_attrs)


def write_exr(path, img: np.ndarray):
    """Scanline ZIP-compressed EXR writer (float32 RGB)."""
    h, w, _ = img.shape
    channels = [("B", img[..., 2]), ("G", img[..., 1]), ("R", img[..., 0])]
    _write_exr_channels(path, w, h, channels, b"")


def _write_exr_channels(path, w, h, channels, extra_attrs):

    def attr(name, type_, data):
        return (name.encode() + b"\0" + type_.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    chlist = b""
    for name, _ in channels:
        chlist += name.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\0"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([3]))  # ZIP
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", bytes([0]))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += extra_attrs
    header += b"\0"

    # ZIP compression groups 16 scanlines per block
    blocks = []
    for y0 in range(0, h, 16):
        rows = np.stack([np.asarray(ch[y0:y0 + 16], "<f4")
                         for _, ch in channels], axis=1)   # [y, ch, x]
        raw = rows.tobytes()
        # EXR zip pre-filter: de-interleave split first, then delta predictor
        # (OpenEXR ImfZip::compress order)
        a = np.frombuffer(raw, np.uint8)
        half = (len(a) + 1) // 2
        split = np.empty_like(a)
        split[:half] = a[0::2]
        split[half:] = a[1::2]
        d = split.astype(np.int16)
        out = np.empty_like(d)
        out[0] = d[0]
        out[1:] = d[1:] - d[:-1] + 128 + 256
        comp = zlib.compress((out & 0xFF).astype(np.uint8).tobytes())
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 20000630))  # magic
        f.write(struct.pack("<I", 2))         # version
        f.write(header)
        offset_table_pos = f.tell()
        n_blocks = len(blocks)
        f.write(b"\0" * (8 * n_blocks))
        offsets = []
        for y0, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<i", y0))
            f.write(struct.pack("<I", len(comp)))
            f.write(comp)
        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))
