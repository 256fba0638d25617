"""sofalizer: binaural renderer driven by SOFA (AES69) HRTF files.

The port of gst_plugins_rs_tpu/elements/audiofx/sofalizer.py (parity
target: audio/hrtf/src/sofa/imp.rs): the element shape of hrtfrender (N
channels -> stereo, block = block-length samples), but the HRIRs come from a
SOFA file (read with h5py) and the rendering is uniformly partitioned
convolution (partition-length, default 64); LFE channels are dropped;
filters are re-selected from the SOFA sphere only when an object moves more
than `update-threshold`.  The partition spectra and the frequency-domain
delay lines live on the selected device; one `upols_block` call renders a
partition of every channel.
"""
from __future__ import annotations

from typing import List, Optional

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
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    audio_caps_template,
    register,
)
from ...ops.sofa import SofaFile, partition_filter, upols_block
from .hrtfrender import SpatialObject, spatial_caps


def to_system(coord_system: str, obj: SpatialObject):
    """Convert an object's position into the configured SOFA coordinate
    system (spatial.rs conversions)."""
    x, y, z = obj.x, obj.y, obj.z
    src = obj.coordinate_system
    # first to cartesian
    if src == "left-handed":
        cx, cy, cz = z, -x, y
    elif src == "right-handed":
        cx, cy, cz = -z, -x, y
    else:
        cx, cy, cz = x, y, z
    if coord_system == "cartesian":
        return (cx, cy, cz)
    if coord_system == "left-handed":
        return (-cy, cz, cx)
    return (-cy, cz, -cx)


@register
class Sofalizer(BaseTransform):
    ELEMENT_NAME = "sofalizer"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Renders spatial sounds with a SOFA file"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False

    SINK_CAPS = audio_caps_template(formats=("F32",))
    SRC_CAPS = audio_caps_template(formats=("F32",), channels=2)

    PROPERTIES = [
        Prop("sofa", None, type="str", mutable="ready", doc="SOFA file location"),
        Prop("sofa-coordinate-system", "cartesian", type="enum",
             choices=["cartesian", "left-handed", "right-handed"], mutable="ready"),
        Prop("partition-length", 64, type="uint64", mutable="ready"),
        Prop("block-length", 256, type="uint64", mutable="ready"),
        Prop("neighbor-angle-step", 0.5, mutable="ready"),
        Prop("neighbor-radius-step", 0.5, mutable="ready"),
        Prop("update-threshold", 0.01, mutable="playing",
             doc="Re-select HRIR when an object moves farther than this"),
        Prop("use-rayon", False, type="bool", mutable="ready",
             doc="Accepted for API parity; channels are batched on device"),
        Prop("spatial-objects", None, type="object", mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._adapter = Adapter()
        self._sofa: Optional[SofaFile] = None
        self._in_info: Optional[AudioInfo] = None
        self._H = None  # ([C, P, 2, L+1] re, im) partition spectra (zeros for Drop)
        self._fdl = None  # ([C, P, L+1] re, im)
        self._prev = None  # [C, L]
        self._objs: Optional[List[SpatialObject]] = None
        self._applied: Optional[List[Optional[tuple]]] = None
        self._drop: List[bool] = []

    # -- negotiation (the caps rewrite of hrtfrender) --------------------------
    def transform_caps(self, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
        return spatial_caps(self, direction, caps, filter_)

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self._in_info = AudioInfo.from_caps(incaps)
        path = self.get_property("sofa")
        if path is None:
            raise FlowError(FlowReturn.NOT_NEGOTIATED, "No SOFA file set")
        self._sofa = SofaFile.from_file(path)

        objs = self.get_property("spatial-objects")
        if objs is None:
            objs = [SpatialObject.from_channel_position(p) for p in self._in_info.positions]
        else:
            objs = [SpatialObject.from_any(o) for o in objs]
        if len(objs) != self._in_info.channels:
            raise FlowError(FlowReturn.NOT_NEGOTIATED, "Wrong number of spatial objects")
        self._props["spatial-objects"] = objs
        self._objs = objs
        # LFE channels are dropped (imp.rs:76-101)
        self._drop = [p == ChannelPosition.LFE1 for p in self._in_info.positions]

        L = self.get_property("partition-length")
        n_taps = self._sofa.ir.shape[-1]
        P = max(1, -(-n_taps // L))
        C = self._in_info.channels
        dev = device()

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._H = (z(C, P, 2, L + 1), z(C, P, 2, L + 1))
        self._fdl = (z(C, P, L + 1), z(C, P, L + 1))
        self._prev = z(C, L)
        self._applied = [None] * C
        self._update_filters(force=True)
        self._adapter.clear()

    def _update_filters(self, force: bool = False) -> None:
        objs = self.get_property("spatial-objects")
        thr = self.get_property("update-threshold")
        system = self.get_property("sofa-coordinate-system")
        L = self.get_property("partition-length")
        for c, obj in enumerate(objs):
            if self._drop[c]:
                continue
            obj = SpatialObject.from_any(obj)
            pos = to_system(system, obj)
            prev = self._applied[c]
            if not force and prev is not None:
                d = sum((a - b) ** 2 for a, b in zip(pos, prev)) ** 0.5
                if d <= thr:
                    continue
            idx = self._sofa.nearest(pos)
            Hr, Hi = partition_filter(self._sofa.hrir(idx), L)  # [P, 2, L+1]
            self._H[0][c] = torch.from_numpy(Hr)
            self._H[1][c] = torch.from_numpy(Hi)
            self._applied[c] = pos

    def property_changed(self, name, value) -> None:
        if name == "spatial-objects" and value is not None and self._sofa is not None:
            self._props[name] = [SpatialObject.from_any(o) for o in value]
            self._update_filters()

    # -- processing ----------------------------------------------------------------
    def _block_samples(self) -> int:
        return self.get_property("block-length")

    def _process(self, data):
        """data: [n*block, C] -> [n*block, 2]"""
        L = self.get_property("partition-length")
        dev = self._prev.device
        gains = torch.tensor(
            [0.0 if self._drop[c] else SpatialObject.from_any(o).distance_gain
             for c, o in enumerate(self.get_property("spatial-objects"))],
            dtype=torch.float32, device=dev)
        x = (torch.as_tensor(data).to(dev, torch.float32) * gains[None, :]).T  # [C, n]
        fdl_re, fdl_im = self._fdl
        Hr, Hi = self._H
        outs = []
        for i in range(0, x.shape[1], L):
            fdl_re, fdl_im, self._prev, y = upols_block(fdl_re, fdl_im, self._prev,
                                                        x[:, i:i + L], Hr, Hi)
            outs.append(y.sum(0))  # mix channels -> [L, 2]
        self._fdl = (fdl_re, fdl_im)
        return torch.cat(outs, dim=0)

    def submit_input_buffer(self, buf: Buffer) -> None:
        self._adapter.push(buf)

    def generate_output(self) -> Optional[Buffer]:
        info = self._in_info
        blk = self._block_samples()
        if info is None or self._adapter.available() < blk:
            return None
        pts, dist = self._adapter.prev_pts()
        off, _ = self._adapter.prev_offset()
        n = (self._adapter.available() // blk) * blk
        out = self._process(self._adapter.take(n))
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        out_off = None if off is None else off + dist
        return Buffer(out, pts=out_pts, offset=out_off, duration=n * SECOND // info.rate)

    def _reset_delay_lines(self) -> None:
        if self._fdl is not None:
            self._fdl = tuple(torch.zeros_like(a) for a in self._fdl)
            self._prev = torch.zeros_like(self._prev)

    def drain(self) -> Optional[Buffer]:
        info = self._in_info
        avail = self._adapter.available()
        if info is None or avail == 0:
            return None
        pts, dist = self._adapter.prev_pts()
        off, _ = self._adapter.prev_offset()
        pad = (-avail) % self._block_samples()
        data = torch.as_tensor(self._adapter.take(avail)).to(self._prev.device, torch.float32)
        data = torch.cat([data, data.new_zeros((pad, info.channels))])
        out = self._process(data)[:avail]
        self._reset_delay_lines()
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        out_off = None if off is None else off + dist
        return Buffer(out, pts=out_pts, offset=out_off, duration=avail * SECOND // info.rate)

    def sink_event(self, event: Event) -> bool:
        if event.type == EventType.FLUSH_STOP:
            self._adapter.clear()
            self._reset_delay_lines()
        return True

    def stop(self) -> None:
        self._adapter.clear()
        self._sofa = None
        self._in_info = None
        self._H = None
        self._fdl = None
        self._prev = None


__all__ = ["Sofalizer"]
