"""videocompare: compares video pads against a reference pad by perceptual hash.

The port of gst_plugins_rs_tpu/elements/video/videocompare.py (parity
target video/videofx/src/videocompare/imp.rs + hashed_image.rs): an
Aggregator whose first sink pad is the reference; the src pad passes the
reference buffer through; each aggregate cycle hashes every other pad's
frame (ops/imagehash.py, on the device) and compares it with the
reference's; when any distance <= max-dist-threshold a `videocompare`
element message is posted with pad-distances and running-time.  Hash
algorithms: mean/gradient/vertgradient/doublegradient/blockhash.  One
distance a pad and frame is read back.
"""
from __future__ import annotations

import torch

from ...core import (
    FlowReturn,
    Message,
    MessageType,
    Prop,
    Structure,
    register,
    video_caps_template,
)
from ...core.aggregator import Aggregator
from ..._device import device
from ...ops.imagehash import hamming, hash_image

_ALGOS = ["mean", "gradient", "vertgradient", "doublegradient", "blockhash"]


@register
class VideoCompare(Aggregator):
    ELEMENT_NAME = "videocompare"
    ELEMENT_CLASS = "Filter/Video"
    ELEMENT_DESCRIPTION = "Compare similarity of video frames"
    SINK_TEMPLATE_CAPS = video_caps_template(("RGB", "RGBA"))
    SRC_TEMPLATE_CAPS = video_caps_template(("RGB", "RGBA"))

    PROPERTIES = [
        Prop("hash-algo", "blockhash", type="enum", choices=_ALGOS, mutable="ready"),
        Prop("max-dist-threshold", 0.0, minimum=0.0, mutable="playing",
             doc="Maximum distance threshold to post a message (0 = exact match)"),
    ]

    def aggregate(self, timeout: bool) -> FlowReturn:
        pads = self.agg_pads()
        ref_pad = pads[0]
        ref = ref_pad.pop_buffer()
        if ref is None:
            return FlowReturn.OK
        dev = device()
        algo = self.get_property("hash-algo")
        ref_hash = hash_image(torch.as_tensor(ref.data, device=dev), algo=algo)

        distances = []
        for pad in pads[1:]:
            buf = pad.pop_buffer()
            if buf is None:
                continue
            if buf.data.shape != ref.data.shape:
                raise RuntimeError(
                    f"{self.name}: video streams do not have the same sizes "
                    f"({ref.data.shape} vs {buf.data.shape})"
                )
            other = hash_image(torch.as_tensor(buf.data, device=dev), algo=algo)
            distances.append((pad.name, float(hamming(ref_hash, other))))

        if distances and any(d <= self.get_property("max-dist-threshold") for _, d in distances):
            running_time = (
                ref_pad.segment.to_running_time(ref.pts)
                if ref_pad.segment is not None and ref.pts is not None
                else ref.pts
            )
            s = Structure(
                "videocompare",
                **{
                    "pad-distances": tuple(
                        Structure("pad-distance", pad=name, distance=d) for name, d in distances
                    ),
                    "running-time": running_time,
                },
            )
            self.post_message(Message(MessageType.ELEMENT, structure=s))

        # src outputs the reference stream
        return self.finish_buffer(ref)


__all__ = ["VideoCompare"]
