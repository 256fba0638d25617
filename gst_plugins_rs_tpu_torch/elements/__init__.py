"""Element library of the port.  Importing this package registers the
factories ported so far: the YOLOX detection slice and its plumbing, and the
per-pixel video effects (colorlut, hsvfilter, hsvdetector)."""
from . import sinks, sources  # noqa: F401
from .analytics import combiner, meta, yoloxinference, yoloxtensordec  # noqa: F401
from .generic import basic  # noqa: F401
from .video import colorlut, hsv  # noqa: F401
