"""Image codec elements: rspngenc, gifenc, gifdec, rswebpdec, imagersdec.

Parity targets: video/png (rspngenc, pngenc/imp.rs:28), video/gif
(gifenc/gifdec), video/webp (rswebpdec), video/image (imagersdec).  The
reference wraps Rust codec crates (png, gif, image-rs); here the codec
library is PIL — same architectural role (host-side codec library at the
pipeline boundary), the hot video path stays device arrays.

gifenc matches the reference's accumulate-then-emit-at-EOS behavior with
the `repeat` property (gifenc/imp.rs:157-181: -1 = no repeat, 0 = forever).

Pillow is imported inside the functions that need it, never when the
module is imported.  Decoders put each frame on the device
`gst_plugins_rs_tpu_torch.set_device` selects, once; encoders read a frame
on the device back once (`core/payload.py`).  The JAX elements emit and
take host arrays.  A decoder emits every frame of a stream in the format of
its caps, the first frame's: Pillow decodes an animated GIF's first frame
as palette (RGBA here) and the later ones as RGB, which the JAX decoder
passes on as 3-channel frames under RGBA caps; here they carry alpha 255.
"""
from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    register,
    video_caps_template,
)
from ..._device import device
from ...core.caps import Structure
from ...core.payload import host_array, host_bytes


def pillow():
    """Pillow's Image module, the codecs' library (imported on first use)."""
    from PIL import Image

    return Image


def pillow_features() -> dict:
    """The installed Pillow's version and whether it decodes WebP."""
    import PIL
    from PIL import features

    return {"version": PIL.__version__, "webp": bool(features.check("webp"))}


RGB_IN = video_caps_template(("RGB", "RGBA"))


class _FrameEncBase(BaseTransform):
    """video frames in, encoded bytes out."""

    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = RGB_IN

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _to_image(self, buf: Buffer):
        arr = host_array(buf.data)  # a frame on the device: one read-back
        mode = "RGBA" if arr.shape[-1] == 4 else "RGB"
        return pillow().fromarray(arr, mode)


@register
class PngEnc(_FrameEncBase):
    ELEMENT_NAME = "rspngenc"
    ELEMENT_CLASS = "Codec/Encoder/Image"
    ELEMENT_DESCRIPTION = "PNG image encoder"
    SRC_CAPS = Caps.builder("image/png")
    PROPERTIES = [
        Prop("compression-level", 6, type="uint", minimum=0, maximum=9),
        Prop("filter", "Adaptive", type="enum",
             choices=["NoFilter", "Sub", "Up", "Avg", "Paeth", "Adaptive"],
             doc="PNG row filter strategy; the PIL encoder picks "
                 "adaptively — explicit filters are accepted and recorded, "
                 "the backend has no per-filter override"),
    ]

    def transform(self, inbuf: Buffer) -> Buffer:
        bio = io.BytesIO()
        self._to_image(inbuf).save(
            bio, "PNG", compress_level=self.get_property("compression-level")
        )
        out = Buffer(np.frombuffer(bio.getvalue(), np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class GifEnc(_FrameEncBase):
    """Accumulates frames, emits one animated GIF at EOS (gifenc/imp.rs)."""

    ELEMENT_NAME = "gifenc"
    ELEMENT_CLASS = "Codec/Encoder/Video"
    ELEMENT_DESCRIPTION = "GIF video encoder"
    SRC_CAPS = Caps.builder("image/gif")
    PROPERTIES = [
        Prop("repeat", -1, type="int", minimum=-1, maximum=65535,
             doc="-1 = once, 0 = loop forever, n = n extra loops"),
        Prop("speed", 10, type="int", minimum=1, maximum=30,
             doc="speed/quality tradeoff: >=15 skips palette optimization "
                 "for faster encodes (the PIL backend's only speed knob)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frames: List = []
        self._durations: List[int] = []
        self._pts0: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._frames = []
        self._durations = []
        self._pts0 = None

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        if self._pts0 is None:
            self._pts0 = inbuf.pts or 0
        self._frames.append(self._to_image(inbuf))
        dur_ms = (inbuf.duration or (SECOND // 30)) // 1_000_000
        self._durations.append(max(int(dur_ms), 2))
        return None

    def drain(self) -> Optional[Buffer]:
        if not self._frames:
            return None
        bio = io.BytesIO()
        repeat = self.get_property("repeat")
        kwargs = {}
        if repeat >= 0:
            kwargs["loop"] = repeat  # PIL loop=0 means forever, like GIF NETSCAPE ext
        if self.get_property("speed") >= 15:
            kwargs["optimize"] = False  # fast path: skip palette optimization
        self._frames[0].save(
            bio, "GIF", save_all=True, append_images=self._frames[1:],
            duration=self._durations, **kwargs,
        )
        out = Buffer(np.frombuffer(bio.getvalue(), np.uint8), pts=self._pts0)
        self._frames = []
        return out


class _ImageDecBase(BaseTransform):
    """encoded byte stream in (whole image per stream at EOS), frames out."""

    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = video_caps_template(("RGB", "RGBA"))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _handle_caps(self, incaps: Caps) -> bool:
        # real dims/format come from the decoded image at drain time;
        # a template fixate here would claim 1x1 frames downstream
        self.in_caps = incaps
        return True

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        d = inbuf.data
        self._acc += d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
        return None

    def _decode_frames(self) -> List[Tuple[np.ndarray, int]]:
        """[(frame, duration_ns)] from the accumulated bytes."""
        img = pillow().open(io.BytesIO(bytes(self._acc)))
        frames = []
        n = getattr(img, "n_frames", 1)
        mode = "RGBA" if img.mode in ("RGBA", "P", "LA") else "RGB"
        for i in range(n):
            img.seek(i)
            rgb = img.convert(mode)  # every frame in the first frame's format
            dur = int(img.info.get("duration", 33)) * 1_000_000
            frames.append((np.asarray(rgb), dur))
        return frames

    def drain(self) -> Optional[Buffer]:
        if not self._acc:
            return None
        frames = self._decode_frames()
        self._acc = bytearray()
        # push all but the last directly, return the last (drain contract)
        pts = 0
        from ...core.events import Event

        first = frames[0][0]
        fmt = "RGBA" if first.shape[-1] == 4 else "RGB"
        caps = Caps.builder("video/x-raw", format=fmt,
                            width=int(first.shape[1]), height=int(first.shape[0]))
        self.out_caps = caps
        self.srcpad.current_caps = caps
        self.srcpad.push_event(Event.new_caps(caps))
        for arr, dur in frames[:-1]:
            self.srcpad.push(Buffer(self._upload(arr), pts=pts, duration=dur))
            pts += dur
        arr, dur = frames[-1]
        return Buffer(self._upload(arr), pts=pts, duration=dur)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(self._device)


@register
class GifDec(_ImageDecBase):
    ELEMENT_NAME = "gifdec"
    ELEMENT_CLASS = "Codec/Decoder/Video"
    ELEMENT_DESCRIPTION = "GIF video decoder"
    SINK_CAPS = Caps.builder("image/gif")
    PROPERTIES = [
        Prop("loop", False, type="bool",
             doc="respects the file's finite repeat count by default "
                 "(frames re-emitted that many times); infinite repeat — "
                 "and loop=true — emit one extra pass, since an unbounded "
                 "drain cannot terminate (divergence from the reference's "
                 "endless loop)"),
    ]

    def _decode_frames(self):
        frames = super()._decode_frames()
        if len(frames) <= 1:
            return frames
        img = pillow().open(io.BytesIO(bytes(self._acc)))
        # GIF NETSCAPE extension: info["loop"] 0 = infinite, n = n extras.
        # Infinite repeat can't terminate a drain, so it plays once unless
        # loop=true asks for the extra pass (documented divergence).
        file_loop = img.info.get("loop")
        extra = 1 if self.get_property("loop") else int(file_loop or 0)
        return frames * (1 + min(extra, 16))  # bound runaway repeat counts


@register
class WebPDec(_ImageDecBase):
    ELEMENT_NAME = "rswebpdec"
    ELEMENT_CLASS = "Codec/Decoder/Video"
    ELEMENT_DESCRIPTION = "WebP image/animation decoder"
    SINK_CAPS = Caps.builder("image/webp")


@register
class ImageDec(_ImageDecBase):
    """Decodes still images (PNG/JPEG/...; reference imagersdec wraps
    image-rs, video/image/src/decoder/imp.rs:23)."""

    ELEMENT_NAME = "imagersdec"
    ELEMENT_CLASS = "Codec/Decoder/Image"
    ELEMENT_DESCRIPTION = "Still image decoder (PNG/JPEG/...)"
    SINK_CAPS = Caps(
        [Structure("image/png"), Structure("image/jpeg"), Structure("image/bmp"),
         Structure("image/tiff"), Structure("image/gif"), Structure("image/webp"),
         # further PIL-decodable types from the reference's image-rs list
         Structure("image/x-MS-bmp"), Structure("image/x-icon"),
         Structure("image/vnd.ms-dds"), Structure("image/x-portable-anymap"),
         Structure("image/x-portable-bitmap"),
         Structure("image/x-portable-graymap"),
         Structure("image/x-portable-pixmap"), Structure("image/x-tga"),
         Structure("image/x-targa"), Structure("image/vnd.zbrush.pcx"),
         Structure("image/x-pcx"), Structure("image/x-xbitmap"),
         Structure("image/x-xbm"), Structure("image/sgi"),
         Structure("image/vnd.wap.wbmp")]
    )
    PROPERTIES = [
        Prop("max-size-bytes", 0, type="uint64",
             doc="max encoded bytes to buffer before failing (0=disable)"),
        Prop("max-alloc-bytes", 0, type="uint64",
             doc="max decoded allocation in bytes (0=disable); oversized "
                 "images are rejected instead of decoded"),
    ]

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        limit = self.get_property("max-size-bytes")
        d = inbuf.data
        size = (len(d) if isinstance(d, str)
                else int(d.nbytes) if isinstance(d, torch.Tensor) else int(np.asarray(d).nbytes))
        if limit and len(self._acc) + size > limit:
            raise ValueError(
                f"{self.name}: encoded image exceeds max-size-bytes={limit}")
        return super().transform(inbuf)

    def _decode_frames(self):
        limit = self.get_property("max-alloc-bytes")
        if limit:
            img = pillow().open(io.BytesIO(bytes(self._acc)))
            if img.width * img.height * 4 > limit:
                raise ValueError(
                    f"{self.name}: decoded size {img.width}x{img.height} "
                    f"exceeds max-alloc-bytes={limit}")
        return super()._decode_frames()


__all__ = ["PngEnc", "GifEnc", "GifDec", "WebPDec", "ImageDec", "pillow", "pillow_features"]
