"""The image elements: the Pillow-backed codecs (rspngenc, gifenc, gifdec,
rswebpdec, imagersdec), imagersoverlay and CD+G (cdgparse, cdgdec)."""
from . import cdg, codecs, overlay  # noqa: F401
