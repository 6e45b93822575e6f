"""Build the glyph atlas that ``tpfl_torch.learning.dataset.rendered``
draws its digits from.

The reference renders each digit glyph with PIL from matplotlib's bundled
DejaVu fonts (``tpfl.learning.dataset.rendered._glyph``). The port imports
neither, so this script renders every glyph the port can ask for once,
through the reference's own ``_glyph``, and stores them in one ``.npz``:

- ``pixels``: every glyph's uint8 pixels, flattened and concatenated;
- ``table``: int32 rows ``(font index, font size, digit, offset, h, w)``;
- ``fonts``: the font basenames in the reference's sorted order (the
  renderer's ``font_idx`` indexes this order);
- ``versions``: the Pillow, FreeType and matplotlib versions the glyphs
  came from (other versions may rasterise differently).

The zip is written with fixed timestamps, so the same versions give the
same file byte for byte. The port never runs this script.

Usage (from the repository root, where PIL and matplotlib are installed)::

    python tests/make_torch_glyph_atlas.py [--out PATH] [--min-size 21] [--max-size 40]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import zipfile

import numpy as np

DEFAULT_OUT = os.path.join("tpfl_torch", "learning", "dataset", "glyphs.npz")


def build_atlas(min_size: int = 21, max_size: int = 40) -> dict[str, np.ndarray]:
    """Every glyph of fonts × sizes ``min_size..max_size`` × digits 0-9."""
    import matplotlib
    from PIL import Image, features

    from tpfl.learning.dataset.rendered import _font_paths, _glyph

    fonts = _font_paths()
    chunks, rows, offset = [], [], 0
    for fi, path in enumerate(fonts):
        for fs in range(min_size, max_size + 1):
            for digit in range(10):
                g = np.ascontiguousarray(_glyph(path, fs, digit), dtype=np.uint8)
                chunks.append(g.ravel())
                rows.append((fi, fs, digit, offset, g.shape[0], g.shape[1]))
                offset += g.size
    versions = np.array([f"Pillow {Image.__version__}",
                         f"FreeType {features.version('freetype2')}",
                         f"matplotlib {matplotlib.__version__}"])
    return {
        "pixels": np.concatenate(chunks),
        "table": np.asarray(rows, dtype=np.int32),
        "fonts": np.array([os.path.basename(p) for p in fonts]),
        "versions": versions,
    }


def write_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez_compressed`` with fixed member timestamps."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue(), compresslevel=9)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--min-size", type=int, default=21)
    p.add_argument("--max-size", type=int, default=40)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    arrays = build_atlas(args.min_size, args.max_size)
    write_npz(args.out, arrays)
    print(f"{args.out}: {len(arrays['table'])} glyphs, {arrays['pixels'].size} pixels, "
          f"{os.path.getsize(args.out)} bytes ({', '.join(arrays['versions'])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
