"""Draws the glyph atlas of cea608overlay and writes it to the port's data.

    python -m gst_plugins_rs_tpu_torch.utils.cea608_atlas

The overlay renders captions from a bitmap font: one 8x12 tile for each
printable ASCII character (0x20-0x7e), drawn with Pillow's default font.
The glyphs depend on the Pillow version, so the port carries the atlas as
data (`gst_plugins_rs_tpu_torch/data/cea608_atlas.npz`: `glyphs`, uint8
[95, 12, 8], the drawn 8-bit coverage; `pillow_version`, the version that
drew them): the captions look the same on every machine, and the port
needs no Pillow when it runs.  Only this script imports it.  Run it again
to follow a Pillow upgrade that changes the default font.
"""
from __future__ import annotations

import pathlib

import numpy as np

GLYPH_W, GLYPH_H = 8, 12
ATLAS_CHARS = [chr(c) for c in range(0x20, 0x7F)]
ATLAS_PATH = pathlib.Path(__file__).resolve().parents[1] / "data" / "cea608_atlas.npz"


def draw_glyphs() -> np.ndarray:
    """uint8 [n_chars, GLYPH_H, GLYPH_W]: each character drawn in white on
    black at (0, 0) in Pillow's default font."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    glyphs = np.zeros((len(ATLAS_CHARS), GLYPH_H, GLYPH_W), np.uint8)
    for i, ch in enumerate(ATLAS_CHARS):
        img = Image.new("L", (GLYPH_W, GLYPH_H), 0)
        ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
        glyphs[i] = np.asarray(img, np.uint8)
    return glyphs


def main() -> None:
    import PIL

    np.savez_compressed(ATLAS_PATH, glyphs=draw_glyphs(),
                        pillow_version=np.array(PIL.__version__))
    print(f"wrote {ATLAS_PATH} (Pillow {PIL.__version__})")


if __name__ == "__main__":
    main()
