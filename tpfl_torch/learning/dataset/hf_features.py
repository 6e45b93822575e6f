"""Hugging Face ``datasets`` features and local dataset directories,
without the ``datasets`` package.

:func:`apply` reads the features ``datasets`` stores in a Parquet file's
schema metadata (key ``huggingface``) and gives the columns the values
the reference's ``Dataset`` gives (``np.asarray`` of them for images):

- ``Value``, ``ClassLabel`` (int64 labels), ``List`` / ``Sequence`` /
  ``LargeList`` and nested dicts: as the Parquet reader reads them;
- ``Array2D``-``Array5D``: one array ``[n, *shape]`` of the feature's dtype;
- ``Image``: the bytes, or a file at ``path`` (a relative path is opened
  from the working directory, as ``datasets`` opens it), decoded by
  :mod:`images` (PNG and JPEG, with the EXIF orientation applied); a
  stacked ``uint8`` array
  ``[n, H, W(, C)]`` where all images share a shape, else an object
  column of arrays;
- any other feature (``Audio``, ``Video``, ``Translation``, ...) raises
  ``NotImplementedError`` naming it.

:func:`data_files` resolves a local directory into splits and their files
as ``load_dataset(directory)`` does (``datasets.data_files``): the
sharded ``data/{split}-NNNNN-of-NNNNN.*`` names, then split keywords in
directory names, then in file names, else everything is ``"train"``;
hidden files, ``__*`` directories and ``README.md`` and the like
ignored, and the loader chosen by the files' extension.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np

from tpfl_torch.learning.dataset import images

_FEATURE_ITEM = "ROADMAP.md §1, the Hugging Face features not ported"
_FOLDER_ITEM = "ROADMAP.md §1, image folders and the other Hub loaders"
_PASS_THROUGH = {"Value", "ClassLabel", "List", "Sequence", "LargeList"}
_ARRAYS = {"Array2D", "Array3D", "Array4D", "Array5D"}


def _check(feature: Any, where: str, top: bool) -> None:
    """Refuse the features this module does not give the reference's
    values for."""
    if isinstance(feature, list):
        for f in feature:
            _check(f, where, False)
        return
    if not isinstance(feature, dict):
        return
    kind = feature.get("_type")
    if kind is None:
        for name, f in feature.items():
            _check(f, f"{where}.{name}", False)
        return
    if kind == "Image":
        if not top:
            raise NotImplementedError(f"column {where!r}: an Image inside another feature "
                                      f"is not ported ({_FEATURE_ITEM})")
        if feature.get("mode"):
            raise NotImplementedError(f"column {where!r}: Image(mode={feature['mode']!r}) "
                                      f"converts the images; not ported ({_FEATURE_ITEM})")
        return
    if kind in _ARRAYS:
        if not top:
            raise NotImplementedError(f"column {where!r}: {kind} inside another feature is "
                                      f"not ported ({_FEATURE_ITEM})")
        return
    if kind not in _PASS_THROUGH:
        raise NotImplementedError(f"column {where!r}: the feature {kind} is not ported "
                                  f"({_FEATURE_ITEM})")
    if "feature" in feature:
        _check(feature["feature"], where, False)


def _images(column: np.ndarray, decode: bool) -> np.ndarray:
    """An ``Image`` column (rows ``{"bytes", "path"}`` or None) as the
    reference's ``np.asarray`` of each image."""
    if not decode:
        return column
    rows = column.tolist()
    blobs, where = [], []
    for i, row in enumerate(rows):
        if row is None:
            continue
        data = row.get("bytes")
        if data is None:
            path = row.get("path")
            if not path:
                raise ValueError(f"image {i}: neither bytes nor a path")
            with open(path, "rb") as f:
                data = f.read()
        blobs.append(data)
        where.append(i)
    arrays = images.decode_many(blobs)
    if len(arrays) == len(rows) and len({(a.shape, a.dtype) for a in arrays}) <= 1 and arrays:
        return np.stack(arrays)
    out = np.empty(len(rows), object)
    for i, a in zip(where, arrays):
        out[i] = a
    return out


def _array(column: np.ndarray, feature: dict) -> np.ndarray:
    """An ``ArrayND`` column as one array, where no row is missing."""
    rows = column.tolist()
    if any(r is None for r in rows):
        return column
    out = np.asarray(rows, dtype=feature["dtype"]) if rows else np.zeros(
        (0, *feature["shape"]), feature["dtype"])
    if out.shape[1:] != tuple(feature["shape"]):
        raise ValueError(f"{feature['_type']} rows of shape {out.shape[1:]}, "
                         f"{tuple(feature['shape'])} declared")
    return out


def features_of(meta: Optional[str]) -> dict[str, Any]:
    """The ``features`` of a ``huggingface`` metadata value ({} without one)."""
    if not meta:
        return {}
    return json.loads(meta).get("info", {}).get("features") or {}


def apply(columns: dict[str, np.ndarray], meta: Optional[str]) -> dict[str, np.ndarray]:
    """The columns as the reference's ``Dataset`` gives them under the
    features in ``meta`` (the ``huggingface`` metadata, or None)."""
    features = features_of(meta)
    out = dict(columns)
    for name, feature in features.items():
        if name not in out:
            continue
        _check(feature, name, True)
        kind = feature.get("_type") if isinstance(feature, dict) else None
        if kind == "Image":
            out[name] = _images(out[name], feature.get("decode", True))
        elif kind in _ARRAYS:
            out[name] = _array(out[name], feature)
    return out


# --- local dataset directories ---------------------------------------------------

_SPLIT_KEYWORDS = {"train": ["train", "training"],
                   "validation": ["validation", "valid", "dev", "val"],
                   "test": ["test", "testing", "eval", "evaluation"]}
_SEP = "[-._ 0-9]"
_IGNORED = {"README.md", "config.json", "dataset_info.json", "dataset_infos.json",
            "dummy_data.zip", "dataset_dict.json"}
#: Loaders by extension (``datasets.packaged_modules``), those ported.
LOADERS = {".parquet": ("parquet", {}), ".geoparquet": ("parquet", {}),
           ".gpq": ("parquet", {}), ".csv": ("csv", {}), ".tsv": ("csv", {"sep": "\t"}),
           ".json": ("json", {}), ".jsonl": ("json", {}), ".ndjson": ("json", {})}
_IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".gif", ".bmp", ".webp", ".tif", ".tiff"}


def _glob(pattern: str) -> re.Pattern:
    """An fsspec-style glob (``**`` across directories, ``*`` within one)."""
    out, i = [], 0
    while i < len(pattern):
        if pattern.startswith("**/", i):
            out.append("(?:.*/)?")
            i += 3
        elif pattern.startswith("**", i):
            out.append(".*")
            i += 2
        elif pattern[i] == "*":
            out.append("[^/]*")
            i += 1
        elif pattern[i] == "[":
            j = pattern.index("]", i)
            out.append(pattern[i:j + 1])
            i = j + 1
        else:
            out.append(re.escape(pattern[i]))
            i += 1
    return re.compile("".join(out))


def _patterns() -> list[dict[str, list[str]]]:
    """``datasets``' default patterns, in the order it tries them."""
    in_dir = {s: [p for k in kws for p in (f"**/{k}/**", f"**/{k}{_SEP}*/**",
                                           f"**/*{_SEP}{k}/**", f"**/*{_SEP}{k}{_SEP}*/**")]
              for s, kws in _SPLIT_KEYWORDS.items()}
    in_name = {s: [p for k in kws for p in (f"**/{k}{_SEP}*", f"**/*{_SEP}{k}{_SEP}*")]
               for s, kws in _SPLIT_KEYWORDS.items()}
    return [{"logs": ["**/*.eval"]}, in_dir, in_name, {"train": ["**"]}]


def _files(root: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith((".", "__"))]
        for f in filenames:
            if f.startswith(".") or f in _IGNORED:
                continue
            out.append(os.path.relpath(os.path.join(dirpath, f), root).replace(os.sep, "/"))
    return sorted(out)


def data_files(root: str) -> tuple[dict[str, list[str]], str, dict[str, Any]]:
    """Splits of a local dataset directory, each with its files in the
    order ``datasets`` reads them, and the loader with its arguments."""
    files = _files(root)
    if not files:
        raise FileNotFoundError(f"The directory at {root} doesn't contain any data files")
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme, encoding="utf-8", errors="replace") as f:
            head = f.read()
        if head.startswith("---") and re.search(r"^(configs|data_files):", head, re.M):
            raise NotImplementedError(f"{readme}: a dataset card's configs are not ported "
                                      f"({_FOLDER_ITEM})")
    splits: dict[str, list[str]] = {}
    sharded = re.compile(r"data/(?P<split>[^/]+?)-\d{5}-of-\d{5}[^/]*\.[^/]*")
    names = {m["split"] for f in files if (m := sharded.fullmatch(f))}
    if names:
        bad = [s for s in names if not re.match(r"^\w+(\.\w+)*$", s)]
        if bad:
            raise ValueError(f"Split name should match '^\\w+(\\.\\w+)*$' but got {bad}")
        order = [s for s in _SPLIT_KEYWORDS if s in names] + sorted(
            names - set(_SPLIT_KEYWORDS))
        for s in order:
            pat = re.compile(rf"data/{re.escape(s)}-\d{{5}}-of-\d{{5}}[^/]*\.[^/]*")
            splits[s] = [f for f in files if pat.fullmatch(f)]
    else:
        for table in _patterns():
            found = {}
            for split, pats in table.items():
                matched = [[f for f in files if _glob(p).fullmatch(f)] for p in pats]
                if any(matched):
                    found[split] = [f for m in matched for f in m]
            if found:
                splits = found
                break
    loaders = set()
    for split_files in splits.values():
        for f in split_files:
            ext = os.path.splitext(f)[1].lower()
            if ext in _IMAGE_EXTENSIONS:
                raise NotImplementedError(f"{root}: an image folder ({f}) is not ported "
                                          f"({_FOLDER_ITEM})")
            if ext not in LOADERS:
                raise NotImplementedError(f"{root}: no ported loader for {f} ({_FOLDER_ITEM})")
            loaders.add(LOADERS[ext][0] + repr(sorted(LOADERS[ext][1].items())))
    if len(loaders) != 1:
        raise NotImplementedError(f"{root}: the files mix loaders ({sorted(loaders)}); not "
                                  f"ported ({_FOLDER_ITEM})")
    ext = os.path.splitext(next(iter(splits.values()))[0])[1].lower()
    name, kwargs = LOADERS[ext]
    return ({s: [os.path.join(root, f) for f in fs] for s, fs in splits.items()},
            name, dict(kwargs))


__all__ = ["LOADERS", "apply", "data_files", "features_of"]
