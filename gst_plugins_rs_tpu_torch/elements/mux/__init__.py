from . import flv, isobmff, tsmux  # noqa: F401
