"""Write the two tables ``viz.py`` draws with, from the libraries that the
card's machine lacks (matplotlib, Pillow):

- ``assets/magma.npy``: matplotlib's magma colormap, its 256 colours as
  (256, 3) float64 RGB in [0, 1] (the colormap's lookup table);
- ``assets/label_font.npz``: the glyphs of ``PIL.ImageFont.load_default()``
  (Pillow's FreeType Aileron Regular at size 10) for the printable ASCII
  characters: each one's anti-aliased coverage as ``ImageDraw.text``
  renders it alone at an integer position, its offset from the pen, and
  its advance.

Run ``python -m vido_slam_tpu_torch.make_viz_assets`` where both are
installed; the package imports neither.
"""

from __future__ import annotations

import os

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
MAGMA = os.path.join(ASSETS, "magma.npy")
FONT = os.path.join(ASSETS, "label_font.npz")
CHARS = "".join(chr(c) for c in range(32, 127))


def magma_table() -> np.ndarray:
    """matplotlib's magma lookup table, (256, 3) float64."""
    import matplotlib

    cmap = matplotlib.colormaps["magma"]
    return np.asarray(cmap(np.arange(cmap.N)), np.float64)[:, :3]


def font_atlas() -> dict:
    """chars (str), glyphs (n, h, w) uint8 coverage, offsets (n, 2) int32
    (x, y) of each glyph's top-left from the pen, advances (n,) int32."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    pad = 16
    glyphs, offsets, advances = [], [], []
    for ch in CHARS:
        canvas = Image.new("L", (3 * pad, 3 * pad))
        ImageDraw.Draw(canvas).text((pad, pad), ch, fill=255, font=font)
        a = np.asarray(canvas)
        ys, xs = np.nonzero(a)
        if len(xs):
            y0, x0 = ys.min(), xs.min()
            glyphs.append(a[y0:ys.max() + 1, x0:xs.max() + 1])
            offsets.append((x0 - pad, y0 - pad))
        else:
            glyphs.append(np.zeros((0, 0), np.uint8))
            offsets.append((0, 0))
        advances.append(font.getlength(ch))
    h = max(g.shape[0] for g in glyphs)
    w = max(g.shape[1] for g in glyphs)
    table = np.zeros((len(CHARS), h, w), np.uint8)
    for i, g in enumerate(glyphs):
        table[i, :g.shape[0], :g.shape[1]] = g
    return dict(chars=np.asarray(CHARS), glyphs=table,
                offsets=np.asarray(offsets, np.int32),
                advances=np.asarray(advances).round().astype(np.int32))


def main() -> None:
    os.makedirs(ASSETS, exist_ok=True)
    np.save(MAGMA, magma_table())
    np.savez_compressed(FONT, **font_atlas())
    print(f"wrote {MAGMA} and {FONT}")


if __name__ == "__main__":
    main()
