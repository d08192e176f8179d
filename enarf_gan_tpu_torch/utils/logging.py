"""Training logs (the port's own copy of ``enarf_gan_tpu/utils/logging.py``):
scalars, PNG image grids, the command line, and the JSON validation log.

``tensorboardX`` is imported inside ``MetricsWriter`` and used when present;
``metrics.jsonl`` is written always. PNGs are written (and read back) with
``zlib`` and ``struct`` alone, since the GPU machine has no PIL: 8-bit RGB,
one IDAT chunk, filter 0 on every row.
"""
from __future__ import annotations

import json
import os
import struct
import sys
import time
import zlib
from typing import Dict

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class MetricsWriter:
    """Scalar writer: tensorboardX when importable, and metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            import tensorboardX
            self._tbx = tensorboardX.SummaryWriter(log_dir)
        except Exception:
            self._tbx = None

    def scalar(self, iteration: int, value, name: str):
        value = float(np.asarray(value))
        if self._tbx is not None:
            self._tbx.add_scalar(f"metrics/{name}", value, iteration)
        self._jsonl.write(json.dumps({"iter": iteration, name: value,
                                      "t": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tbx is not None:
            self._tbx.close()
        self._jsonl.close()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + \
        struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)   # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return PNG_SIGNATURE + _png_chunk(b"IHDR", header) + \
        _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + \
        _png_chunk(b"IEND", b"")


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 image of an 8-bit RGB PNG whose rows all use
    filter 0 (what ``encode_png`` writes); other PNGs raise."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xffffffff:
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError("rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_img_grid(imgs, path: str):
    """Save a (B, C, H, W) batch in [-1, 1] (or (B, H, W) masks) as a
    floor(sqrt(B)) x floor(sqrt(B)) PNG grid, the JAX package's layout."""
    x = np.asarray(imgs)
    B = x.shape[0]
    g = int(np.floor(np.sqrt(B)))
    x = x[:g * g]
    if x.ndim == 3:  # (B, H, W) mask
        x = x[:, None].repeat(3, axis=1)
    if x.shape[1] == 1:
        x = x.repeat(3, axis=1)
    _, C, H, W = x.shape
    x = x.reshape(g, g, C, H, W).transpose(2, 0, 3, 1, 4).reshape(C, g * H,
                                                                   g * W)
    x = np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(x))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def record_command(out_dir: str):
    """Append the command line to ``out_dir``/command.txt."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "command.txt"), "a") as f:
        f.write(" ".join(sys.argv) + "\n")


class JsonLog:
    """Metrics per validation interval, kept in one JSON file."""

    def __init__(self, path: str):
        self.path = path
        self.log: Dict = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self.log = json.load(f)
            except Exception:
                self.log = {}

    def update(self, iteration: int, entry: Dict):
        self.log[str(iteration)] = entry
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.log, f)
