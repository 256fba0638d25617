"""hrtfrender: binaural HRTF renderer (N channels -> stereo).

The port of gst_plugins_rs_tpu/elements/audiofx/hrtfrender.py (parity
target: audio/hrtf/src/hrtf/imp.rs + spatial.rs): block =
interpolation-steps x block-length samples; caps sink F32 interleaved 1-64
channels, src F32 stereo; transform_caps forces the opposite side; spatial
objects per channel ({position, distance-gain}, Cartesian/LeftHanded/
RightHanded coordinates) default from the channel positions; the EOS drain
pads the final partial block with zeros and keeps PTS/offset/duration;
flush-stop clears the adapter.  The HRIR tables are sampled on the host
(ops/hrtf.py HrirSphere) and the convolution runs on the selected device,
where the overlap-add tails stay.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    Adapter,
    AudioInfo,
    BaseTransform,
    Buffer,
    Caps,
    ChannelPosition,
    Event,
    EventType,
    FlowError,
    FlowReturn,
    IntRange,
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    audio_caps_template,
    register,
)
from ...ops.hrtf import HrirSphere, hrtf_convolve_block, hrtf_convolve_blocks

# Default speaker-position coordinates, left-handed (spatial.rs:183-212)
_POSITION_COORDS = {
    ChannelPosition.FRONT_LEFT: (-1.45, 0.0, 2.5),
    ChannelPosition.FRONT_RIGHT: (1.45, 0.0, 2.5),
    ChannelPosition.FRONT_CENTER: (0.0, 0.0, 2.5),
    ChannelPosition.MONO: (0.0, 0.0, 2.5),
    ChannelPosition.LFE1: (0.0, 0.0, 0.0),
    ChannelPosition.REAR_LEFT: (-1.45, 0.0, -2.5),
    ChannelPosition.REAR_RIGHT: (1.45, 0.0, -2.5),
    ChannelPosition.REAR_CENTER: (0.0, 0.0, -2.5),
    ChannelPosition.SIDE_LEFT: (-2.5, 0.0, -0.44),
    ChannelPosition.SIDE_RIGHT: (2.5, 0.0, -0.44),
}


def to_right_handed(coord_system: str, v):
    """Convert a position to right-handed coords (spatial.rs:63-71), the
    system the HRIR sphere mesh lives in."""
    x, y, z = v
    if coord_system == "cartesian":
        return (-y, z, -x)
    if coord_system == "left-handed":
        return (x, y, -z)
    return (x, y, z)


class SpatialObject:
    def __init__(self, x=1000.0, y=1000.0, z=1000.0, distance_gain=1.0,
                 coordinate_system="left-handed"):
        self.x, self.y, self.z = float(x), float(y), float(z)
        self.distance_gain = float(distance_gain)
        self.coordinate_system = coordinate_system

    def direction(self):
        return to_right_handed(self.coordinate_system, (self.x, self.y, self.z))

    @staticmethod
    def from_any(obj) -> "SpatialObject":
        if isinstance(obj, SpatialObject):
            return obj
        if isinstance(obj, dict):
            return SpatialObject(
                obj.get("x", 0.0),
                obj.get("y", 0.0),
                obj.get("z", 0.0),
                obj.get("distance-gain", obj.get("distance_gain", 1.0)),
                obj.get("coordinate-system", obj.get("coordinate_system", "left-handed")),
            )
        raise TypeError(f"cannot convert {obj!r} to SpatialObject")

    @staticmethod
    def from_channel_position(pos: ChannelPosition) -> "SpatialObject":
        if pos not in _POSITION_COORDS:
            raise FlowError(FlowReturn.ERROR, f"Unsupported channel position {pos}")
        x, y, z = _POSITION_COORDS[pos]
        return SpatialObject(x, y, z, 1.0, "left-handed")


def spatial_caps(element, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
    """The caps rewrite of hrtfrender and sofalizer: F32 interleaved, stereo
    on the src side, one channel per spatial object (or 1-64) on the sink
    side."""
    out = caps.copy()
    if out.is_any():
        out = (element.SRC_CAPS if direction == PadDirection.SINK else element.SINK_CAPS).copy()
    for s in out.structures:
        s["format"] = "F32"
        s["layout"] = "interleaved"
        if direction == PadDirection.SINK:
            s["channels"] = 2
        else:
            objs = element.get_property("spatial-objects")
            s["channels"] = len(objs) if objs else IntRange(1, 64)
    if filter_ is not None:
        out = filter_.intersect(out)
    return out


@register
class HrtfRender(BaseTransform):
    ELEMENT_NAME = "hrtfrender"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Renders spatial sounds to a given position"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False

    SINK_CAPS = audio_caps_template(formats=("F32",))
    SRC_CAPS = audio_caps_template(formats=("F32",), channels=2)

    PROPERTIES = [
        Prop("hrir-raw", None, type="bytes", mutable="ready"),
        Prop("hrir-file", None, type="str", mutable="ready"),
        Prop("interpolation-steps", 8, type="uint64", mutable="ready"),
        Prop("block-length", 512, type="uint64", mutable="ready"),
        Prop("use-rayon", False, type="bool", mutable="ready",
             doc="Accepted for API parity; channels are always batched on device"),
        Prop("spatial-objects", None, type="object", mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._adapter = Adapter()
        self._sphere: Optional[HrirSphere] = None
        self._in_info: Optional[AudioInfo] = None
        self._tails = None
        self._prev_obj: Optional[List[SpatialObject]] = None
        self._block_samples = 0

    # -- negotiation ---------------------------------------------------------
    def transform_caps(self, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
        return spatial_caps(self, direction, caps, filter_)

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self._in_info = AudioInfo.from_caps(incaps)
        objs = self.get_property("spatial-objects")
        if objs is None:
            objs = [SpatialObject.from_channel_position(p) for p in self._in_info.positions]
        else:
            objs = [SpatialObject.from_any(o) for o in objs]
        self._props["spatial-objects"] = objs
        if len(objs) != self._in_info.channels:
            raise FlowError(FlowReturn.NOT_NEGOTIATED, "Wrong number of spatial objects")

        raw = self.get_property("hrir-raw")
        path = self.get_property("hrir-file")
        if raw is not None:
            self._sphere = HrirSphere.parse(bytes(raw), self._in_info.rate)
        elif path is not None:
            self._sphere = HrirSphere.from_file(path, self._in_info.rate)
        else:
            raise FlowError(FlowReturn.NOT_NEGOTIATED, "Impulse response not set")

        steps = self.get_property("interpolation-steps")
        blk = self.get_property("block-length")
        self._block_samples = steps * blk
        C = self._in_info.channels
        L = self._sphere.length
        self._tails = torch.zeros((C, 2, max(L - 1, 0)), dtype=torch.float32, device=device())
        self._prev_obj = None
        self._adapter.clear()

    def property_changed(self, name, value) -> None:
        if name == "spatial-objects" and value is not None and \
                not isinstance(value[0] if value else None, SpatialObject):
            self._props[name] = [SpatialObject.from_any(o) for o in value]

    # -- processing ------------------------------------------------------------
    def _hrir_tables(self, prev, objs, steps):
        """Per-step interpolated HRIR [C, steps, 2, L] and gain [C, steps]
        tables for one block transition prev -> objs, on the device.  When
        prev == objs every step's table is the steady-state table."""
        C = self._in_info.channels
        L = self._sphere.length
        hrirs = np.zeros((C, steps, 2, L), np.float32)
        gains = np.zeros((C, steps), np.float32)
        for c, (po, no) in enumerate(zip(prev, objs)):
            pv = np.asarray(po.direction(), np.float64)
            nv = np.asarray(no.direction(), np.float64)
            for s in range(steps):
                t = (s + 1) / steps
                vec = pv + (nv - pv) * t
                l, r = self._sphere.sample_bilinear(vec)
                hrirs[c, s, 0] = l
                hrirs[c, s, 1] = r
                gains[c, s] = po.distance_gain + (no.distance_gain - po.distance_gain) * t
        dev = self._tails.device
        return torch.from_numpy(hrirs).to(dev), torch.from_numpy(gains).to(dev)

    def _process_block(self, block):
        """block: [steps*blk, C] -> [steps*blk, 2]"""
        steps = self.get_property("interpolation-steps")
        blk = self.get_property("block-length")
        objs: List[SpatialObject] = self.get_property("spatial-objects")
        hrirs, gains = self._hrir_tables(self._prev_obj or objs, objs, steps)
        self._prev_obj = list(objs)
        out, self._tails = hrtf_convolve_block(block.T, hrirs, gains, self._tails,
                                               block_len=blk, steps=steps)
        return out

    def _process_blocks(self, blocks):
        """blocks: [K, steps*blk, C] -> [K*steps*blk, 2].  The first block
        interpolates from the previous objects to the current ones; the other
        K-1 run the steady-state tables in one hrtf_convolve_blocks call."""
        out0 = self._process_block(blocks[0])
        if blocks.shape[0] == 1:
            return out0
        steps = self.get_property("interpolation-steps")
        blk = self.get_property("block-length")
        objs: List[SpatialObject] = self.get_property("spatial-objects")
        hrirs, gains = self._hrir_tables(objs, objs, steps)
        xs = blocks[1:].permute(2, 0, 1)  # [C, K-1, steps*blk]
        outs, self._tails = hrtf_convolve_blocks(xs, hrirs, gains, self._tails,
                                                 block_len=blk, steps=steps)
        return torch.cat([out0, outs.reshape(-1, 2)], dim=0)

    def _take(self, n: int):
        return torch.as_tensor(self._adapter.take(n)).to(self._tails.device, torch.float32)

    def submit_input_buffer(self, buf: Buffer) -> None:
        self._adapter.push(buf)

    def generate_output(self) -> Optional[Buffer]:
        info = self._in_info
        if info is None or self._adapter.available() < self._block_samples:
            return None
        pts, dist = self._adapter.prev_pts()
        off, _ = self._adapter.prev_offset()
        n_blocks = self._adapter.available() // self._block_samples
        n = n_blocks * self._block_samples
        data = self._take(n)
        out = self._process_blocks(data.reshape(n_blocks, self._block_samples, -1))
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        out_off = None if off is None else off + dist
        return Buffer(out, pts=out_pts, offset=out_off, duration=n * SECOND // info.rate)

    def drain(self) -> Optional[Buffer]:
        info = self._in_info
        avail = self._adapter.available()
        if info is None or avail == 0:
            return None
        pts, dist = self._adapter.prev_pts()
        off, _ = self._adapter.prev_offset()
        data = self._take(avail)
        block = torch.zeros((self._block_samples, info.channels), dtype=torch.float32,
                            device=data.device)
        block[:avail] = data
        out = self._process_block(block)[:avail]
        self._tails = torch.zeros_like(self._tails)
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        out_off = None if off is None else off + dist
        return Buffer(out, pts=out_pts, offset=out_off, duration=avail * SECOND // info.rate)

    def sink_event(self, event: Event) -> bool:
        if event.type == EventType.FLUSH_STOP:
            self._adapter.clear()
            if self._tails is not None:
                self._tails = torch.zeros_like(self._tails)
        return True

    def stop(self) -> None:
        self._adapter.clear()
        self._sphere = None
        self._in_info = None
        self._tails = None
        self._prev_obj = None


__all__ = ["HrtfRender", "SpatialObject", "spatial_caps"]
