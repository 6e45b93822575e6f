"""Write the Hugging Face dataset directories that ``chip_smoke.py``'s
phases 26 and 28 and ``tests/test_torch_hf_local.py`` /
``tests/test_torch_hf_jpeg.py`` read through the port's Parquet reader
(``TpflDataset.from_huggingface`` / ``from_parquet``).

The images are the port's ``rendered_color_digits`` (512 train and 128
test images, seed 7, 32×32×3), quantised to uint8 by ``np.rint(x * 255)``,
with their digit labels. ``datasets`` writes them as a Hub dataset does
(``Dataset.to_parquet``): an ``Image()`` column of image bytes and a
``ClassLabel(num_classes=10)`` column, the features in the schema
metadata, under ``data/{train,test}-00000-of-00001.parquet``. ``datasets``
leaves the image column uncompressed and compresses the labels with
Snappy and a dictionary; the train file has data pages v1, the test
file data pages v2.

``--format png`` (``tests/data/torch_hf_digits``) stores the images as
the PNG bytes ``datasets`` encodes itself. ``--format jpeg``
(``tests/data/torch_hf_jpeg_digits``) stores JPEG bytes PIL writes: the
train split baseline at quality 90 with 4:2:0 subsampling, the test
split progressive with ``optimize=True``, 4:2:2 subsampling and a
restart marker after every MCU row (``JPEG`` below).

The script then loads the directory with the reference's loader
(``tpfl.learning.dataset.TpflDataset.from_huggingface``) and prints the
sha256 of each split's image and label arrays: the pins the chip script
and the tests hold the port's reader to. The port never runs this script.

Usage (from the repository root, where ``datasets`` and PIL are installed)::

    python tests/make_torch_parquet_fixture.py [--format png|jpeg] [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys

import numpy as np

DEFAULT_OUT = {"png": os.path.join("tests", "data", "torch_hf_digits"),
               "jpeg": os.path.join("tests", "data", "torch_hf_jpeg_digits")}
N_TRAIN, N_TEST, SEED = 512, 128, 7
#: PIL's JPEG options per split of the ``jpeg`` fixture.
JPEG = {"train": {"quality": 90, "subsampling": "4:2:0"},
        "test": {"quality": 90, "subsampling": "4:2:2", "progressive": True, "optimize": True,
                 "restart_marker_rows": 1}}
FILES = {"train": "data/train-00000-of-00001.parquet",
         "test": "data/test-00000-of-00001.parquet"}
WRITER = {"train": {}, "test": {"data_page_version": "2.0"}}


def quantised_digits() -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Each split's uint8 images and int64 labels, from the port's renderer."""
    from tpfl_torch.learning.dataset import rendered_color_digits

    ds = rendered_color_digits(N_TRAIN, N_TEST, seed=SEED)
    out = {}
    for split, train in (("train", True), ("test", False)):
        part = ds.get_split(train)
        x = np.rint(np.asarray(part["image"], np.float32) * 255).astype(np.uint8)
        out[split] = (x, np.asarray(part["label"], np.int64))
    return out


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pins(directory: str) -> dict[str, str]:
    """sha256 of each split's ``np.asarray`` of images and labels, as the
    reference's loader reads the directory."""
    from tpfl.learning.dataset import TpflDataset

    ds = TpflDataset.from_huggingface(directory)
    out = {}
    for split, train in (("train", True), ("test", False)):
        part = ds.get_split(train)
        out[f"{split}_image"] = sha256(np.asarray(part["image"], np.uint8))
        out[f"{split}_label"] = sha256(np.asarray(part["label"], np.int64))
    return out


def jpeg_bytes(image: np.ndarray, options: dict) -> dict:
    """One image as the ``{"bytes", "path"}`` row of JPEG bytes PIL writes."""
    import io

    from PIL import Image as PILImage

    buf = io.BytesIO()
    PILImage.fromarray(image).save(buf, "JPEG", **options)
    return {"bytes": buf.getvalue(), "path": None}


def write(directory: str, fmt: str = "png") -> None:
    from datasets import ClassLabel, Dataset, Features, Image

    features = Features({"image": Image(), "label": ClassLabel(num_classes=10)})
    if os.path.isdir(directory):
        shutil.rmtree(directory)
    for split, (x, y) in quantised_digits().items():
        path = os.path.join(directory, FILES[split])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rows = list(x) if fmt == "png" else [jpeg_bytes(a, JPEG[split]) for a in x]
        Dataset.from_dict({"image": rows, "label": y.tolist()}, features=features
                          ).to_parquet(path, **WRITER[split])


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--format", choices=sorted(DEFAULT_OUT), default="png")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    args.out = args.out or DEFAULT_OUT[args.format]
    write(args.out, args.format)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in FILES.values())
    print(f"wrote {args.out}: {size} bytes")
    for key, digest in pins(args.out).items():
        print(f"{key} {digest}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
