"""gst_plugins_rs_tpu_torch: the media-effects framework on PyTorch and CUDA.

The port of `gst_plugins_rs_tpu` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100.  The GStreamer element contract
(caps negotiation, properties, pads/events, BaseTransform chain semantics)
is the same host glue; buffer payloads are `torch.Tensor`s that stay on the
device, plain tensor code is PyTorch, and each kernel the JAX package wrote
in Pallas becomes a kernel written by hand for Hopper (`csrc/`).

Entry points run on CUDA unless the caller asks for the CPU with
`set_device("cpu")`; with no CUDA device and no such request they raise.
"""

__version__ = "0.1.0"

from . import elements  # noqa: F401  (registers the element library)
from .core import (  # noqa: F401
    Buffer,
    BufferFlags,
    Caps,
    Element,
    Event,
    EventType,
    Fraction,
    Harness,
    Message,
    MessageType,
    Pipeline,
    Segment,
    State,
    Structure,
    element_factory_make,
    list_factories,
    parse_caps,
    parse_launch,
)
from ._device import (  # noqa: F401
    device,
    no_tf32,
    requested_device,
    set_device,
    set_virtual_devices,
    visible_devices,
)
