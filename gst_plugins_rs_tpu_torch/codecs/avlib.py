"""ctypes wrapper over native/avshim.cpp (system libavcodec).

Powers the codec-wrapper elements the reference builds on C libraries:
dav1ddec (libdav1d via avcodec), rav1enc (librav1e), ffv1dec, lewtondec
(vorbis) — the same wrap-the-system-codec architecture as the reference's
-sys crates, loaded on demand with a clear error when the shim can't
build.  Video is exchanged as I420 planes; audio as interleaved f32, all
host numpy arrays: the elements over the shim put decoded frames on the
device.

The shim is the repository's shared native library (native/avshim.cpp),
built with `make -C native libgstpu_avshim.so` at first use
(utils/native_build.py), never with the whole Makefile.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..utils import native_build

NATIVE_DIR = native_build.NATIVE_DIR  # the loader reads it at its first call
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # only the shim's own target: it links -lavcodec -lavformat -lavutil,
    # which a machine without those libraries cannot (available() is then
    # False and every codec element raises at its first use)
    lib = native_build.load(NATIVE_DIR, "AVSHIM", "libgstpu_avshim.so")
    if lib is None:
        return None
    c = ctypes
    u8p, f32p = c.POINTER(c.c_uint8), c.POINTER(c.c_float)
    ip, lp = c.POINTER(c.c_int), c.POINTER(c.c_long)
    lib.avshim_decoder_new.restype = c.c_void_p
    lib.avshim_decoder_new.argtypes = [c.c_char_p, u8p, c.c_int, c.c_int, c.c_int]
    lib.avshim_video_encoder_new.restype = c.c_void_p
    lib.avshim_video_encoder_new.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                             c.c_int, c.c_int, c.c_long, c.c_char_p]
    lib.avshim_audio_encoder_new.restype = c.c_void_p
    lib.avshim_audio_encoder_new.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_long]
    lib.avshim_frame_size.argtypes = [c.c_void_p]
    lib.avshim_extradata.argtypes = [c.c_void_p, u8p, c.c_int]
    lib.avshim_send_packet.argtypes = [c.c_void_p, u8p, c.c_int, c.c_long]
    lib.avshim_receive_video.argtypes = [c.c_void_p, u8p, u8p, u8p, ip, ip, lp]
    lib.avshim_receive_audio.argtypes = [c.c_void_p, f32p, c.c_int, ip, ip, ip, lp]
    lib.avshim_send_video.argtypes = [c.c_void_p, u8p, u8p, u8p, c.c_long]
    lib.avshim_send_audio_f32.argtypes = [c.c_void_p, f32p, c.c_int, c.c_long]
    lib.avshim_receive_packet.argtypes = [c.c_void_p, u8p, c.c_int, lp, ip]
    lib.avshim_free.argtypes = [c.c_void_p]
    lib.avdemux_open.restype = c.c_void_p
    lib.avdemux_open.argtypes = [c.c_char_p]
    lib.avdemux_format_name.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.avdemux_nb_streams.argtypes = [c.c_void_p]
    lib.avdemux_duration.restype = c.c_long
    lib.avdemux_duration.argtypes = [c.c_void_p]
    lib.avdemux_stream_info.argtypes = [c.c_void_p, c.c_int, c.c_char_p,
                                        c.c_int, ip, ip, ip, ip, ip, ip, ip,
                                        u8p, c.c_int, ip]
    lib.avdemux_stream_language.argtypes = [c.c_void_p, c.c_int, c.c_char_p,
                                            c.c_int]
    lib.avdemux_read.argtypes = [c.c_void_p, ip, lp, lp, lp, ip, u8p,
                                 c.c_int, ip]
    lib.avdemux_close.argtypes = [c.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class VideoDecoder:
    """I420-plane decoder (av1/libdav1d, ffv1, vp8, vp9, h264, theora...)."""

    def __init__(self, codec: str, extradata: bytes = b"",
                 width: int = 0, height: int = 0,
                 max_w: int = 4096, max_h: int = 2304):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavcodec shim unavailable (native build failed)")
        extra = np.frombuffer(extradata, np.uint8) if extradata else np.zeros(0, np.uint8)
        self._lib = lib
        self._ctx = lib.avshim_decoder_new(codec.encode(), _u8(extra),
                                           len(extradata), width, height)
        if not self._ctx:
            raise RuntimeError(f"decoder {codec!r} unavailable in libavcodec")
        self._y = np.empty(max_w * max_h, np.uint8)
        self._u = np.empty(max_w * max_h // 4, np.uint8)
        self._v = np.empty(max_w * max_h // 4, np.uint8)

    def decode(self, packet: Optional[bytes], pts: int = 0):
        """-> [(y, u, v, pts)] I420 planes; packet=None flushes."""
        lib = self._lib
        if packet is None:
            lib.avshim_send_packet(self._ctx, None, 0, 0)
        else:
            data = np.frombuffer(packet, np.uint8)
            if lib.avshim_send_packet(self._ctx, _u8(data), len(packet), pts) < 0:
                raise ValueError("decoder rejected packet")
        out = []
        w, h, p = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        while True:
            ret = lib.avshim_receive_video(self._ctx, _u8(self._y), _u8(self._u),
                                           _u8(self._v), ctypes.byref(w),
                                           ctypes.byref(h), ctypes.byref(p))
            if ret == 1:
                break
            if ret < 0:
                raise ValueError(f"decode error {ret}")
            W, H = w.value, h.value
            out.append((
                self._y[: W * H].reshape(H, W).copy(),
                self._u[: W * H // 4].reshape(H // 2, W // 2).copy(),
                self._v[: W * H // 4].reshape(H // 2, W // 2).copy(),
                p.value,
            ))
        return out

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.avshim_free(self._ctx)
            self._ctx = None


class VideoEncoder:
    def __init__(self, codec: str, width: int, height: int,
                 fps=(30, 1), bitrate: int = 1_000_000, opts: str = ""):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavcodec shim unavailable")
        self._lib = lib
        self._ctx = lib.avshim_video_encoder_new(
            codec.encode(), width, height, fps[0], fps[1], bitrate, opts.encode())
        if not self._ctx:
            raise RuntimeError(f"encoder {codec!r} unavailable in libavcodec")
        self._buf = np.empty(width * height * 4 + 4096, np.uint8)

    @property
    def extradata(self) -> bytes:
        out = np.empty(65536, np.uint8)
        n = self._lib.avshim_extradata(self._ctx, _u8(out), out.size)
        return out[:n].tobytes() if n > 0 else b""

    def _drain(self) -> List[Tuple[bytes, int, bool]]:
        out = []
        pts, key = ctypes.c_long(), ctypes.c_int()
        while True:
            n = self._lib.avshim_receive_packet(self._ctx, _u8(self._buf),
                                                self._buf.size, ctypes.byref(pts),
                                                ctypes.byref(key))
            if n == 1:
                break
            if n < 0:
                raise ValueError(f"encode error {n}")
            out.append((self._buf[:n].tobytes(), pts.value, bool(key.value)))
        return out

    def encode(self, y: Optional[np.ndarray], u=None, v=None, pts: int = 0):
        """-> [(packet, pts, keyframe)]; y=None flushes."""
        lib = self._lib
        if y is None:
            lib.avshim_send_video(self._ctx, None, None, None, 0)
        else:
            ya = np.ascontiguousarray(y, np.uint8)
            ua = np.ascontiguousarray(u, np.uint8)
            va = np.ascontiguousarray(v, np.uint8)
            if lib.avshim_send_video(self._ctx, _u8(ya), _u8(ua), _u8(va), pts) < 0:
                raise ValueError("encoder rejected frame")
        return self._drain()

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.avshim_free(self._ctx)
            self._ctx = None


class AudioDecoder:
    def __init__(self, codec: str, extradata: bytes = b""):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavcodec shim unavailable")
        extra = np.frombuffer(extradata, np.uint8) if extradata else np.zeros(0, np.uint8)
        self._lib = lib
        self._ctx = lib.avshim_decoder_new(codec.encode(), _u8(extra),
                                           len(extradata), 0, 0)
        if not self._ctx:
            raise RuntimeError(f"decoder {codec!r} unavailable in libavcodec")
        self._buf = np.empty(1 << 20, np.float32)

    def decode(self, packet: Optional[bytes], pts: int = 0):
        """-> [(samples [n, ch] f32, rate, pts)]; packet=None flushes."""
        lib = self._lib
        if packet is None:
            lib.avshim_send_packet(self._ctx, None, 0, 0)
        else:
            data = np.frombuffer(packet, np.uint8)
            if lib.avshim_send_packet(self._ctx, _u8(data), len(packet), pts) < 0:
                raise ValueError("decoder rejected packet")
        out = []
        ns, ch, rate, p = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                           ctypes.c_long())
        while True:
            ret = lib.avshim_receive_audio(
                self._ctx, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._buf.size, ctypes.byref(ns), ctypes.byref(ch),
                ctypes.byref(rate), ctypes.byref(p))
            if ret == 1:
                break
            if ret < 0:
                raise ValueError(f"decode error {ret}")
            n, c = ns.value, ch.value
            out.append((self._buf[: n * c].reshape(n, c).copy(), rate.value, p.value))
        return out

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.avshim_free(self._ctx)
            self._ctx = None


class AudioEncoder:
    def __init__(self, codec: str, rate: int, channels: int,
                 bitrate: int = 128_000):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavcodec shim unavailable")
        self._lib = lib
        self._ctx = lib.avshim_audio_encoder_new(codec.encode(), rate, channels, bitrate)
        if not self._ctx:
            raise RuntimeError(f"encoder {codec!r} unavailable in libavcodec")
        self.channels = channels
        self.frame_size = lib.avshim_frame_size(self._ctx) or 1024
        self._buf = np.empty(1 << 20, np.uint8)

    @property
    def extradata(self) -> bytes:
        out = np.empty(65536, np.uint8)
        n = self._lib.avshim_extradata(self._ctx, _u8(out), out.size)
        return out[:n].tobytes() if n > 0 else b""

    def encode(self, samples: Optional[np.ndarray], pts: int = 0):
        """samples: [n, ch] f32 (must be frame_size rows except at flush)."""
        lib = self._lib
        if samples is None:
            lib.avshim_send_audio_f32(self._ctx, None, 0, 0)
        else:
            arr = np.ascontiguousarray(samples, np.float32)
            if lib.avshim_send_audio_f32(
                self._ctx, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                arr.shape[0], pts) < 0:
                raise ValueError("encoder rejected frame")
        out = []
        pp, key = ctypes.c_long(), ctypes.c_int()
        while True:
            n = lib.avshim_receive_packet(self._ctx, _u8(self._buf), self._buf.size,
                                          ctypes.byref(pp), ctypes.byref(key))
            if n == 1:
                break
            if n < 0:
                raise ValueError(f"encode error {n}")
            out.append((self._buf[:n].tobytes(), pp.value))
        return out

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.avshim_free(self._ctx)
            self._ctx = None


class Demuxer:
    """libavformat demux handle — the EXTERNAL oracle for container output.

    Everything the in-repo muxers write (isobmff/mpegts/flv/HLS segments)
    can be probed and demuxed by the system ffmpeg libraries, which never
    shared a line of code with mux/bmff.py — matching the confidence the
    reference gets from ecosystem interop (mux/isobmff/tests/tests_fmp4.rs
    drives real decoders)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libavformat shim unavailable (native build failed)")
        self._lib = lib
        self._ctx = lib.avdemux_open(path.encode())
        if not self._ctx:
            raise ValueError(f"libavformat could not open {path!r}")
        self._buf = np.empty(1 << 22, np.uint8)

    @property
    def format_name(self) -> str:
        out = ctypes.create_string_buffer(256)
        self._lib.avdemux_format_name(self._ctx, out, 256)
        return out.value.decode()

    @property
    def nb_streams(self) -> int:
        return self._lib.avdemux_nb_streams(self._ctx)

    @property
    def duration_us(self) -> int:
        """Container duration in microseconds (AV_TIME_BASE units)."""
        return self._lib.avdemux_duration(self._ctx)

    def stream_info(self, idx: int) -> dict:
        c = ctypes
        name = c.create_string_buffer(128)
        ints = [c.c_int() for _ in range(7)]
        extra = np.empty(1 << 16, np.uint8)
        elen = c.c_int()
        rc = self._lib.avdemux_stream_info(
            self._ctx, idx, name, 128, *(c.byref(i) for i in ints),
            _u8(extra), extra.size, c.byref(elen))
        if rc != 0:
            raise IndexError(f"stream {idx}")
        lang = c.create_string_buffer(16)
        self._lib.avdemux_stream_language(self._ctx, idx, lang, 16)
        ctype, w, h, rate, ch, tbn, tbd = (i.value for i in ints)
        return {
            "codec": name.value.decode(),
            "type": {0: "video", 1: "audio"}.get(ctype, "other"),
            "width": w, "height": h,
            "sample_rate": rate, "channels": ch,
            "time_base": (tbn, tbd),
            "extradata": extra[: elen.value].tobytes() if elen.value > 0 else b"",
            "language": lang.value.decode(),
        }

    def read(self) -> Optional[dict]:
        """Next packet as a dict, or None at EOF."""
        c = ctypes
        sidx, key, size = c.c_int(), c.c_int(), c.c_int()
        pts, dts, dur = c.c_long(), c.c_long(), c.c_long()
        while True:
            n = self._lib.avdemux_read(
                self._ctx, c.byref(sidx), c.byref(pts), c.byref(dts),
                c.byref(dur), c.byref(key), _u8(self._buf), self._buf.size,
                c.byref(size))
            if n == -1:
                return None
            if n == -2:
                self._buf = np.empty(size.value + 4096, np.uint8)
                continue
            if n < 0:
                raise ValueError(f"demux error {n}")
            return {
                "stream": sidx.value, "pts": pts.value, "dts": dts.value,
                "duration": dur.value, "keyframe": bool(key.value),
                "data": self._buf[:n].tobytes(),
            }

    def packets(self):
        while True:
            pkt = self.read()
            if pkt is None:
                return
            yield pkt

    def close(self) -> None:
        if getattr(self, "_ctx", None):
            self._lib.avdemux_close(self._ctx)
            self._ctx = None

    def __del__(self):
        self.close()


def parse_xiph_extradata(extradata: bytes) -> List[bytes]:
    """Split libavcodec's xiph-laced vorbis extradata into header packets."""
    if not extradata or extradata[0] != 2:
        return [extradata] if extradata else []
    sizes = []
    pos = 1
    for _ in range(2):
        n = 0
        while extradata[pos] == 255:
            n += 255
            pos += 1
        n += extradata[pos]
        pos += 1
        sizes.append(n)
    out = []
    for n in sizes:
        out.append(extradata[pos : pos + n])
        pos += n
    out.append(extradata[pos:])
    return out


def build_xiph_extradata(headers: List[bytes]) -> bytes:
    """Inverse of parse_xiph_extradata (3 vorbis header packets)."""
    out = bytearray([2])
    for h in headers[:2]:
        n = len(h)
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)
    for h in headers:
        out += h
    return bytes(out)


__all__ = ["available", "VideoDecoder", "VideoEncoder", "AudioDecoder",
           "AudioEncoder", "Demuxer", "parse_xiph_extradata",
           "build_xiph_extradata"]
