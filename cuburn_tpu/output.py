"""Output sinks: PNG/JPEG stills and raw/y4m video pipes.

Equivalent of the reference's cuburn/output.py (SURVEY.md §2 layer 5):
PNG still writer plus a frame pipe suitable for feeding ffmpeg / x264
downstream.  PNG and y4m need nothing beyond the standard library and
numpy; only JPEG needs PIL.
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
import sys
import zlib
from typing import IO, Optional

import numpy as np

try:  # native encoders (cuburn_tpu/native/fastout.c); optional
    from cuburn_tpu.native import fastout as _fastout
except ImportError:  # pragma: no cover
    _fastout = None


def write_image(path: str, img: np.ndarray):
    """Write a (H, W, 4) or (H, W, 3) u8 frame as PNG/JPEG by
    extension (RGB is upgraded to opaque RGBA, like the video sinks).

    PNG goes through the native zlib encoder when built (the per-frame
    host hot path), else through encode_png; JPEG needs PIL."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"writing {path}: JPEG output needs PIL (Pillow), "
                "which is not installed; write .png instead") from None
        Image.fromarray(arr[..., :3], "RGB").save(path, quality=95)
        return
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)],
            axis=2)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        if _fastout is not None:
            f.write(_fastout.encode_png(arr.tobytes(), w, h))
        else:
            f.write(encode_png(arr))


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 4) u8 -> PNG bytes (8-bit RGBA, unfiltered scanlines,
    zlib deflate): the standard-library fallback of the native
    encoder."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape != (h, w, 4) or h <= 0 or w <= 0:
        raise ValueError(f"need a non-empty (H, W, 4) frame, got "
                         f"{rgba.shape}")
    raw = np.zeros((h, 1 + 4 * w), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = rgba.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) u8 for 8-bit RGB/RGBA files with any
    scanline filter (what encode_png and the native encoder write)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _c, _f, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type "
                         f"{ctype}, interlace {interlace}")
    bpp = 4 if ctype == 6 else 3
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: running sum along the row
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = line + prev   # uint8 arithmetic wraps mod 256
        else:                   # Average, Paeth: byte by byte
            cur = bytearray(stride)
            up = prev.tobytes()
            for x, v in enumerate(line.tobytes()):
                left = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (left + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = left + b - c
                    pa, pb, pc = abs(p - left), abs(p - b), abs(p - c)
                    pred = left if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                cur[x] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)


class Y4MSink:
    """Stream frames as yuv4mpeg2 (mono-convertible by any encoder).

    Writes 4:4:4 YCbCr; plays with `mpv file.y4m` or pipes into
    `ffmpeg -i - out.mp4`."""

    def __init__(self, stream_or_path, width: int, height: int,
                 fps: float = 24.0):
        if isinstance(stream_or_path, (str, os.PathLike)):
            self.stream: IO[bytes] = open(stream_or_path, "wb")
            self._own = True
        else:
            self.stream = stream_or_path
            self._own = False
        num = int(round(fps * 1000))
        # XCOLORRANGE=FULL: the frames are full-range BT.601; without
        # the param decoders assume limited range and crush contrast
        self.stream.write(
            f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 C444 "
            f"XCOLORRANGE=FULL\n".encode())

    def write_frame(self, img: np.ndarray):
        arr = np.ascontiguousarray(img, dtype=np.uint8)
        if arr.ndim == 3 and arr.shape[2] == 3:
            # native path needs RGBA; accept RGB on both paths alike
            arr = np.concatenate(
                [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)],
                axis=2)
        h, w = arr.shape[:2]
        self.stream.write(b"FRAME\n")
        if _fastout is not None:
            self.stream.write(
                _fastout.rgb_to_ycbcr444(arr.tobytes(), w, h))
            return
        rgb = arr[..., :3].astype(np.float32) / 255.0
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 0.5 + (b - y) * 0.564
        cr = 0.5 + (r - y) * 0.713
        for plane in (y, cb, cr):
            self.stream.write(
                np.clip(plane * 255.0 + 0.5, 0, 255)
                .astype(np.uint8).tobytes())

    def close(self):
        if self._own:
            self.stream.close()


class FFmpegSink:
    """Pipe frames into ffmpeg if available (H.264 etc.).

    Equivalent of the reference's encoder pipe (SURVEY.md §3.1 process
    boundary at output)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 24.0, codec: str = "libx264"):
        import tempfile
        self.path = path
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgba",
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
             "-an", "-c:v", codec, "-pix_fmt", "yuv420p", path],
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=self._err)

    def write_frame(self, img: np.ndarray):
        img = np.asarray(img, np.uint8)
        if img.ndim == 3 and img.shape[2] == 3:
            # ffmpeg was launched expecting rgba frames; silently
            # writing w*h*3 bytes would shift every later frame
            # boundary (Y4MSink upgrades RGB the same way)
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                axis=2)
        try:
            self.proc.stdin.write(img.tobytes())
        except BrokenPipeError:
            raise RuntimeError(
                f"ffmpeg died while encoding {self.path}:\n"
                + self._err_tail())

    def _err_tail(self) -> str:
        try:
            self._err.seek(0)
            return self._err.read().decode(
                errors="replace")[-2000:]
        except Exception:
            return "(stderr unavailable)"

    def close(self):
        try:
            self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            # ffmpeg already died with buffered stdin pending; fall
            # through so the user sees rc + the stderr tail, not a
            # raw BrokenPipeError
            pass
        rc = self.proc.wait()
        tail = self._err_tail()
        self._err.close()
        if rc != 0:
            raise RuntimeError(
                f"ffmpeg exited with {rc} for {self.path}:\n{tail}")


def make_video_sink(path: str, width: int, height: int, fps: float):
    if path.endswith(".y4m"):
        return Y4MSink(path, width, height, fps)
    try:
        subprocess.run(["ffmpeg", "-version"], capture_output=True,
                       timeout=10)
        return FFmpegSink(path, width, height, fps)
    except (OSError, subprocess.TimeoutExpired):
        y4m = os.path.splitext(path)[0] + ".y4m"
        print(f"ffmpeg unavailable; writing {y4m}", file=sys.stderr)
        return Y4MSink(y4m, width, height, fps)
