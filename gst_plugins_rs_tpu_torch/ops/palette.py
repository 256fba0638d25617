"""Dominant-palette extraction and CSS colour naming (colordetect's compute path).

The port of gst_plugins_rs_tpu/ops/palette.py, a rebuild of the
reference's color-thief + color-name pipeline
(video/videofx/src/colordetect/imp.rs:57-102): pixels are sampled with a
`quality` step, near-white and transparent pixels are skipped, the rest are
quantized to 5 bits a channel, and a modified median cut (MMCQ) over the
histogram yields the palette; the dominant colour maps to the nearest CSS
colour name.  The 32^3-bin histogram is built on the device with one
integer `index_add_` (exact, whatever the order of the adds); the median
cut and the naming run on the host over the small histogram, as in the JAX
package (copied as they are).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

SIGBITS = 5
RSHIFT = 8 - SIGBITS
HIST_SIZE = 1 << (3 * SIGBITS)

# CSS3 extended color keywords (standard list)
CSS_COLORS = {
    "aliceblue": 0xF0F8FF, "antiquewhite": 0xFAEBD7, "aqua": 0x00FFFF,
    "aquamarine": 0x7FFFD4, "azure": 0xF0FFFF, "beige": 0xF5F5DC,
    "bisque": 0xFFE4C4, "black": 0x000000, "blanchedalmond": 0xFFEBCD,
    "blue": 0x0000FF, "blueviolet": 0x8A2BE2, "brown": 0xA52A2A,
    "burlywood": 0xDEB887, "cadetblue": 0x5F9EA0, "chartreuse": 0x7FFF00,
    "chocolate": 0xD2691E, "coral": 0xFF7F50, "cornflowerblue": 0x6495ED,
    "cornsilk": 0xFFF8DC, "crimson": 0xDC143C, "cyan": 0x00FFFF,
    "darkblue": 0x00008B, "darkcyan": 0x008B8B, "darkgoldenrod": 0xB8860B,
    "darkgray": 0xA9A9A9, "darkgreen": 0x006400, "darkkhaki": 0xBDB76B,
    "darkmagenta": 0x8B008B, "darkolivegreen": 0x556B2F, "darkorange": 0xFF8C00,
    "darkorchid": 0x9932CC, "darkred": 0x8B0000, "darksalmon": 0xE9967A,
    "darkseagreen": 0x8FBC8F, "darkslateblue": 0x483D8B, "darkslategray": 0x2F4F4F,
    "darkturquoise": 0x00CED1, "darkviolet": 0x9400D3, "deeppink": 0xFF1493,
    "deepskyblue": 0x00BFFF, "dimgray": 0x696969, "dodgerblue": 0x1E90FF,
    "firebrick": 0xB22222, "floralwhite": 0xFFFAF0, "forestgreen": 0x228B22,
    "fuchsia": 0xFF00FF, "gainsboro": 0xDCDCDC, "ghostwhite": 0xF8F8FF,
    "gold": 0xFFD700, "goldenrod": 0xDAA520, "gray": 0x808080,
    "green": 0x008000, "greenyellow": 0xADFF2F, "honeydew": 0xF0FFF0,
    "hotpink": 0xFF69B4, "indianred": 0xCD5C5C, "indigo": 0x4B0082,
    "ivory": 0xFFFFF0, "khaki": 0xF0E68C, "lavender": 0xE6E6FA,
    "lavenderblush": 0xFFF0F5, "lawngreen": 0x7CFC00, "lemonchiffon": 0xFFFACD,
    "lightblue": 0xADD8E6, "lightcoral": 0xF08080, "lightcyan": 0xE0FFFF,
    "lightgoldenrodyellow": 0xFAFAD2, "lightgray": 0xD3D3D3, "lightgreen": 0x90EE90,
    "lightpink": 0xFFB6C1, "lightsalmon": 0xFFA07A, "lightseagreen": 0x20B2AA,
    "lightskyblue": 0x87CEFA, "lightslategray": 0x778899, "lightsteelblue": 0xB0C4DE,
    "lightyellow": 0xFFFFE0, "lime": 0x00FF00, "limegreen": 0x32CD32,
    "linen": 0xFAF0E6, "magenta": 0xFF00FF, "maroon": 0x800000,
    "mediumaquamarine": 0x66CDAA, "mediumblue": 0x0000CD, "mediumorchid": 0xBA55D3,
    "mediumpurple": 0x9370DB, "mediumseagreen": 0x3CB371, "mediumslateblue": 0x7B68EE,
    "mediumspringgreen": 0x00FA9A, "mediumturquoise": 0x48D1CC, "mediumvioletred": 0xC71585,
    "midnightblue": 0x191970, "mintcream": 0xF5FFFA, "mistyrose": 0xFFE4E1,
    "moccasin": 0xFFE4B5, "navajowhite": 0xFFDEAD, "navy": 0x000080,
    "oldlace": 0xFDF5E6, "olive": 0x808000, "olivedrab": 0x6B8E23,
    "orange": 0xFFA500, "orangered": 0xFF4500, "orchid": 0xDA70D6,
    "palegoldenrod": 0xEEE8AA, "palegreen": 0x98FB98, "paleturquoise": 0xAFEEEE,
    "palevioletred": 0xDB7093, "papayawhip": 0xFFEFD5, "peachpuff": 0xFFDAB9,
    "peru": 0xCD853F, "pink": 0xFFC0CB, "plum": 0xDDA0DD,
    "powderblue": 0xB0E0E6, "purple": 0x800080, "rebeccapurple": 0x663399,
    "red": 0xFF0000, "rosybrown": 0xBC8F8F, "royalblue": 0x4169E1,
    "saddlebrown": 0x8B4513, "salmon": 0xFA8072, "sandybrown": 0xF4A460,
    "seagreen": 0x2E8B57, "seashell": 0xFFF5EE, "sienna": 0xA0522D,
    "silver": 0xC0C0C0, "skyblue": 0x87CEEB, "slateblue": 0x6A5ACD,
    "slategray": 0x708090, "snow": 0xFFFAFA, "springgreen": 0x00FF7F,
    "steelblue": 0x4682B4, "tan": 0xD2B48C, "teal": 0x008080,
    "thistle": 0xD8BFD8, "tomato": 0xFF6347, "turquoise": 0x40E0D0,
    "violet": 0xEE82EE, "wheat": 0xF5DEB3, "white": 0xFFFFFF,
    "whitesmoke": 0xF5F5F5, "yellow": 0xFFFF00, "yellowgreen": 0x9ACD32,
}

_CSS_NAMES = list(CSS_COLORS.keys())
_CSS_RGB = np.array(
    [[(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF] for v in CSS_COLORS.values()], np.int32
)


def css_color_name(rgb: Tuple[int, int, int]) -> str:
    d = np.sum((_CSS_RGB - np.asarray(rgb, np.int32)) ** 2, axis=1)
    return _CSS_NAMES[int(np.argmin(d))]


def color_histogram(frame: torch.Tensor, *, quality: int, has_alpha: bool) -> torch.Tensor:
    """[HIST_SIZE] int32 5-bit RGB histogram of an [..., C] u8 frame (r, g, b
    and, with has_alpha, a in that order), with color-thief's sampling rules:
    every `quality`-th pixel, skipping alpha < 125 and near-white (r, g, b
    all > 250)."""
    flat = frame.reshape(-1, frame.shape[-1])[::quality]
    r = flat[:, 0].to(torch.int32)
    g = flat[:, 1].to(torch.int32)
    b = flat[:, 2].to(torch.int32)
    keep = ~((r > 250) & (g > 250) & (b > 250))
    if has_alpha:
        keep &= flat[:, 3].to(torch.int32) >= 125
    idx = ((r >> RSHIFT) << (2 * SIGBITS)) | ((g >> RSHIFT) << SIGBITS) | (b >> RSHIFT)
    hist = torch.zeros(HIST_SIZE, dtype=torch.int32, device=frame.device)
    return hist.index_add_(0, idx, keep.to(torch.int32))


def _vbox_minmax(hist3):
    nz = np.argwhere(hist3 > 0)
    if nz.size == 0:
        return None
    return nz.min(axis=0), nz.max(axis=0)


def median_cut_palette(hist: np.ndarray, max_colors: int) -> List[Tuple[int, int, int]]:
    """Host-side modified median cut over the 5-bit histogram."""
    hist3 = hist.reshape(32, 32, 32)
    first = _vbox_minmax(hist3)
    if first is None:
        return []
    boxes = [(first[0], first[1])]

    def box_count(lo, hi):
        return hist3[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1].sum()

    while len(boxes) < max_colors:
        # split the box with the largest population along its longest axis at
        # the population median
        boxes.sort(key=lambda b: -box_count(*b))
        lo, hi = boxes[0]
        sizes = hi - lo
        axis = int(np.argmax(sizes))
        if sizes[axis] == 0:
            break
        sub = hist3[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1]
        marg = sub.sum(axis=tuple(i for i in range(3) if i != axis))
        cum = np.cumsum(marg)
        total = cum[-1]
        if total == 0:
            break
        cut = int(np.searchsorted(cum, total / 2.0))
        cut = min(max(cut, 0), sizes[axis] - 1)
        hi1 = hi.copy()
        hi1[axis] = lo[axis] + cut
        lo2 = lo.copy()
        lo2[axis] = lo[axis] + cut + 1
        boxes = boxes[1:] + [(lo, hi1), (lo2, hi)]

    scored = []
    for lo, hi in boxes:
        sub = hist3[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1]
        total = sub.sum()
        if total == 0:
            continue
        ridx, gidx, bidx = np.mgrid[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1]
        r = (ridx * sub).sum() / total
        g = (gidx * sub).sum() / total
        b = (bidx * sub).sum() / total
        rgb = (
            int(r * (1 << RSHIFT) + (1 << (RSHIFT - 1))),
            int(g * (1 << RSHIFT) + (1 << (RSHIFT - 1))),
            int(b * (1 << RSHIFT) + (1 << (RSHIFT - 1))),
        )
        scored.append((int(total), rgb))
    scored.sort(key=lambda t: -t[0])  # dominant (most populous box) first
    return [rgb for _, rgb in scored]


__all__ = ["color_histogram", "median_cut_palette", "css_color_name", "CSS_COLORS"]
