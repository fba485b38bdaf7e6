"""Write ``pcgmix_tpu_torch/exp/raster_data.py``: the bitmap font and the
viridis table that the port's numpy raster (``exp/raster.py``) draws with.

The font is DejaVu Sans (matplotlib's default face; Bitstream Vera
license) rendered by Pillow at 14 px, matplotlib's 10 pt at 100 dpi, one
8-bit coverage cell per printable ASCII character.  The viridis table is
matplotlib's 256 entries rounded to 8 bits.  Run with matplotlib and
Pillow installed (neither is needed at run time):

    python scripts/make_raster_data.py
"""

from __future__ import annotations

import base64
import os
import textwrap
import zlib

import numpy as np
from matplotlib import colormaps, font_manager
from PIL import Image, ImageDraw, ImageFont

SIZE = 14
OUT = os.path.join(os.path.dirname(__file__), "..", "pcgmix_tpu_torch", "exp",
                   "raster_data.py")


def main() -> None:
    font = ImageFont.truetype(font_manager.findfont("DejaVu Sans"), SIZE)
    ascent, descent = font.getmetrics()
    height = ascent + descent
    widths, cells = [], []
    for code in range(32, 127):
        ch = chr(code)
        width = max(1, int(round(font.getlength(ch))))
        img = Image.new("L", (width, height), 0)
        ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font, anchor="la")
        widths.append(width)
        cells.append(np.asarray(img, dtype=np.uint8).T.ravel())  # column-major
    glyphs = base64.b64encode(zlib.compress(np.concatenate(cells).tobytes(), 9)).decode()
    viridis = np.round(colormaps["viridis"](np.linspace(0, 1, 256))[:, :3] * 255)
    viridis_hex = viridis.astype(np.uint8).tobytes().hex()
    wrap = lambda s: "\n".join(f'    "{part}"' for part in textwrap.wrap(s, 76))  # noqa: E731
    with open(OUT, "w") as f:
        f.write(f'''"""Data for ``exp/raster.py``, written by ``scripts/make_raster_data.py``:
DejaVu Sans (Bitstream Vera license) at {SIZE} px as 8-bit coverage cells
for the printable ASCII characters, and matplotlib's viridis table in 8
bits."""

FONT_HEIGHT = {height}
FONT_ASCENT = {ascent}
# advance widths of chr(32) .. chr(126), in pixels
FONT_WIDTHS = {widths}
# zlib + base64 of the cells, column-major, FONT_HEIGHT rows each
FONT_CELLS = (
{wrap(glyphs)}
)
# 256 RGB triples, hex
VIRIDIS = (
{wrap(viridis_hex)}
)
''')


if __name__ == "__main__":
    main()
