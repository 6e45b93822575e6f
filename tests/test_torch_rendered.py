"""The port's rendered digit datasets (tpfl_torch.learning.dataset.rendered)
against the JAX package's, on the CPU, where PIL and matplotlib exist.

- ``rendered_digits`` / ``rendered_color_digits`` bit-equal to the
  reference's (``np.array_equal`` on images and labels) at seeds 0, 3 and
  5 and the default sizes (the reference's arrays taken before their
  Hugging Face conversion), and the ``primary`` tier's first 2,048
  canvases (``n_train=51,200, size 32, seed 0``) against PIL's;
- the batched rotate / resize / paste byte-equal to PIL on 2,400 seeded
  (glyph, angle, target, offset) cases, the square angles among them,
  and the batch renderer equal to PIL with square angles in its batch;
- the atlas regenerated by ``tests/make_torch_glyph_atlas.py`` equal byte
  for byte to the committed one; a ``size`` outside it refused;
- a fresh interpreter that renders with neither PIL nor matplotlib
  imported;
- ``chip_smoke.py``'s two pinned digests equal to the reference's and the
  port's, and the primary tier's first 2,048 images and labels equal;
- a 4-node, 1-batch CNN engine window on the port's rendered data against
  the JAX engine on the reference's (rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_engine.py``).
"""

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from tpfl.learning.dataset import rendered as ref
from tpfl_torch.learning.dataset import rendered
from tpfl_torch.learning.dataset import rendered_color_digits, rendered_digits

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def _ref_arrays(ds):
    """A JAX-package TpflDataset's four arrays."""
    def col(train, name):
        return np.asarray(ds.get_split(train).with_format("numpy")[name])
    return col(True, "image"), col(True, "label"), col(False, "image"), col(False, "label")


def _port_arrays(ds):
    return tuple(ds.get_split(train)[name] for train in (True, False)
                 for name in ("image", "label"))


class _Recorder:
    """Stands in for the reference's ``TpflDataset``: ``from_arrays``
    returns the four arrays it is given (before their Hugging Face
    conversion, which is slow and not under test here)."""

    @staticmethod
    def from_arrays(*arrays):
        return arrays


# --- the datasets ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("fn", ["rendered_digits", "rendered_color_digits"])
def test_rendered_datasets_equal_the_reference(fn, seed, monkeypatch):
    monkeypatch.setattr(ref, "TpflDataset", _Recorder)
    want = getattr(ref, fn)(seed=seed)
    got = _port_arrays(getattr(rendered, fn)(seed=seed))
    for g, w, name in zip(got, want, ("x_train", "y_train", "x_test", "y_test")):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def _pil_canvas(glyph, angle, size, shift):
    """The reference's ``_render_batch`` loop body, through PIL."""
    im = Image.fromarray(glyph).rotate(angle, expand=True, resample=Image.BILINEAR)
    target = max(1, int(size * 0.8))
    scale = target / max(im.size)
    im = im.resize((max(1, int(im.size[0] * scale)), max(1, int(im.size[1] * scale))),
                   resample=Image.BILINEAR)
    canvas = Image.new("L", (size, size), 0)
    canvas.paste(im, ((size - im.size[0]) // 2 + int(shift[0]),
                      (size - im.size[1]) // 2 + int(shift[1])))
    return np.asarray(canvas)


def _draws(n, size, seed):
    """The first batch's draws of ``rendered_color_digits(n_train=n,
    seed=seed, size=size)``, in the reference's order."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    font_idx = rng.integers(0, len(ref._font_paths()), size=n)
    font_sizes = rng.integers(size * 3 // 4, size * 5 // 4 + 1, size=n)
    angles = rng.uniform(-25.0, 25.0, size=n)
    shifts = rng.integers(-size // 8, size // 8 + 1, size=(n, 2))
    return y, font_idx, font_sizes, angles, shifts


def test_primary_tier_first_2048_canvases_equal_pil():
    """The ``primary`` tier's call (``rendered_color_digits(n_train=100 ·
    512, n_test=10, seed=0)``): its first 2,048 images' canvases, rendered
    by the port's batch renderer, byte-equal to PIL's at the same draws."""
    size, k = 32, 2048
    y, font_idx, font_sizes, angles, shifts = _draws(100 * 512, size, 0)
    fonts = ref._font_paths()
    want = np.stack([_pil_canvas(ref._glyph(fonts[font_idx[i]], int(font_sizes[i]), int(y[i])),
                                 float(angles[i]), size, shifts[i]) for i in range(k)])
    got = rendered._render_canvases(font_idx[:k], font_sizes[:k], y[:k], angles[:k],
                                    shifts[:k], size)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert rendered._atlas().fonts == tuple(Path(p).name for p in fonts)


# --- the geometry against PIL ------------------------------------------------


SQUARE = (0.0, 90.0, 180.0, 270.0, -90.0, 360.0, 450.0)


def _glyph(key):
    off, h, w = rendered._atlas().index[key]
    return rendered._atlas().pixels[off:off + h * w].reshape(h, w)


@pytest.mark.parametrize("part", range(4))
def test_rotate_resize_paste_equal_pil(part):
    """2,400 seeded cases in all (600 a part, one batch each): a glyph
    rotated (every tenth angle one of ``SQUARE``), resized to a target
    both up and down (every tenth the rotated size, every tenth with one
    side kept), then pasted at an offset that may clip."""
    rng = np.random.default_rng(100 + part)
    atlas = rendered._atlas()
    keys = sorted(atlas.index)
    picked = [keys[i] for i in rng.integers(len(keys), size=600)]
    angles = rng.uniform(-180.0, 180.0, size=600)
    angles[::10] = np.asarray(SQUARE)[rng.integers(len(SQUARE), size=60)]
    off, h, w = np.array([atlas.index[k] for k in picked], dtype=np.int64).T
    rot, nh, nw = rendered.rotate_many(atlas.pixels, off, h, w, angles)
    th, tw = rng.integers(1, 60, size=600), rng.integers(1, 60, size=600)
    th[5::10], tw[5::10] = nh[5::10], nw[5::10]
    th[7::10] = nh[7::10]
    small = rendered.resize_many(rot, nh, nw, th, tw)
    ox, oy = rng.integers(-40, 40, size=600), rng.integers(-40, 40, size=600)
    canvases = rendered.paste_many(small, th, tw, ox, oy, 32)
    for i, key in enumerate(picked):
        pil_rot = Image.fromarray(_glyph(key)).rotate(float(angles[i]), expand=True,
                                                       resample=Image.BILINEAR)
        assert (nw[i], nh[i]) == pil_rot.size, (key, angles[i])
        assert np.array_equal(rot[i, :nh[i], :nw[i]], np.asarray(pil_rot)), (key, angles[i])
        pil_small = pil_rot.resize((int(tw[i]), int(th[i])), resample=Image.BILINEAR)
        assert np.array_equal(small[i, :th[i], :tw[i]], np.asarray(pil_small)), (key, i)
        pil_canvas = Image.new("L", (32, 32), 0)
        pil_canvas.paste(pil_small, (int(ox[i]), int(oy[i])))
        assert np.array_equal(canvases[i], np.asarray(pil_canvas)), (key, i)


def test_batch_renderer_equals_pil_with_square_angles():
    """The vectorised renderer, angles 0/90/180/270 among them (they take
    the per-image path), at sizes 28 and 32."""
    fonts = ref._font_paths()
    rng = np.random.default_rng(7)
    for size in (28, 32):
        n = 300
        y = rng.integers(0, 10, size=n)
        font_idx = rng.integers(0, len(fonts), size=n)
        font_sizes = rng.integers(size * 3 // 4, size * 5 // 4 + 1, size=n)
        angles = rng.uniform(-25.0, 25.0, size=n)
        angles[::7] = np.resize(SQUARE, len(angles[::7]))
        shifts = rng.integers(-size // 8, size // 8 + 1, size=(n, 2))
        got = rendered._render_canvases(font_idx, font_sizes, y, angles, shifts, size)
        want = np.stack([_pil_canvas(ref._glyph(fonts[font_idx[i]], int(font_sizes[i]),
                                                int(y[i])), float(angles[i]), size, shifts[i])
                         for i in range(n)])
        assert np.array_equal(got, want), size


# --- the atlas ----------------------------------------------------------------


def test_atlas_regenerates_byte_for_byte(tmp_path):
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import make_torch_glyph_atlas as make
    finally:
        sys.path.remove(str(REPO / "tests"))
    out = tmp_path / "glyphs.npz"
    assert make.main(["--out", str(out)]) == 0
    assert out.read_bytes() == Path(rendered.ATLAS_PATH).read_bytes()
    atlas = rendered._atlas()
    assert len(atlas.index) == 12 * 20 * 10 and atlas.sizes == (21, 40)
    assert atlas.versions == ("Pillow 12.1.0", "FreeType 2.14.1", "matplotlib 3.10.8")


@pytest.mark.parametrize("fn,size", [(rendered_digits, 27), (rendered_color_digits, 33),
                                     (rendered_digits, 16), (rendered_color_digits, 64)])
def test_size_outside_the_atlas_is_refused(fn, size):
    with pytest.raises(ValueError, match=r"font sizes 21\.\.40.*make_torch_glyph_atlas\.py"):
        fn(n_train=2, n_test=1, size=size)


def test_sizes_inside_the_atlas_render():
    for size in (28, 29, 32):
        x = rendered_digits(n_train=3, n_test=1, size=size).get_split(True)["image"]
        assert x.shape == (3, size, size)


_PROBE = """
import hashlib, json, sys
from tpfl_torch.learning.dataset.rendered import rendered_color_digits, rendered_digits
ds = [rendered_digits(n_train=64, n_test=16, seed=3), rendered_color_digits(n_train=64, n_test=16, seed=3)]
h = [hashlib.sha256(b"".join(d.get_split(t)[k].tobytes() for t in (True, False)
                              for k in ("image", "label"))).hexdigest() for d in ds]
print(json.dumps({"digests": h, "pil": "PIL" in sys.modules,
                  "matplotlib": "matplotlib" in sys.modules}))
"""


def test_renders_without_pil_or_matplotlib():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["pil"] is False and report["matplotlib"] is False
    want = [hashlib.sha256(b"".join(a.tobytes() for a in _ref_arrays(fn(
        n_train=64, n_test=16, seed=3)))).hexdigest()
        for fn in (ref.rendered_digits, ref.rendered_color_digits)]
    assert report["digests"] == want


# --- chip_smoke.py's pins ----------------------------------------------------


def _digest(arrays):
    """chip_smoke.py's ``rendered_digest``: sha256 over each array's dtype,
    shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _pins():
    text = (REPO / "chip_smoke.py").read_text()
    pins = dict(re.findall(r'^(RENDERED_\w+_SHA256) = "([0-9a-f]{64})"', text, re.M))
    assert set(pins) == {"RENDERED_PRIMARY_SHA256", "RENDERED_DIGITS_SHA256"}
    return pins


def test_primary_tier_equals_the_reference_and_the_pin(monkeypatch):
    """The ``primary`` tier's call, ``rendered_color_digits(n_train=100 ·
    512, n_test=10, seed=0)``, in both packages: the reference's four
    arrays (taken before their Hugging Face conversion) and the port's
    hash to ``chip_smoke.py``'s pin, and the first 2,048 images and labels
    are equal."""
    pin = _pins()["RENDERED_PRIMARY_SHA256"]
    monkeypatch.setattr(ref, "TpflDataset", _Recorder)
    want = ref.rendered_color_digits(n_train=100 * 512, n_test=10, seed=0)
    assert _digest(want) == pin
    x_want, y_want = want[0][:2048].copy(), want[1][:2048].copy()
    del want
    got = _port_arrays(rendered_color_digits(n_train=100 * 512, n_test=10, seed=0))
    assert np.array_equal(got[0][:2048], x_want) and np.array_equal(got[1][:2048], y_want)
    assert _digest(got) == pin


def test_digits_pin_equals_the_reference_and_the_port(monkeypatch):
    pin = _pins()["RENDERED_DIGITS_SHA256"]
    assert _digest(_port_arrays(rendered_digits(n_train=2000, n_test=400, seed=0))) == pin
    monkeypatch.setattr(ref, "TpflDataset", _Recorder)
    assert _digest(ref.rendered_digits(n_train=2000, n_test=400, seed=0)) == pin


# --- a CNN engine window on the rendered data ---------------------------------


def test_cnn_engine_window_on_rendered_data_matches_jax():
    """4 nodes, 1 batch of 4 rendered colour digits each, narrow f32 CNNs
    through the conv kernels' plain versions (JAX: Pallas interpret
    mode): params and losses of a 2-round window."""
    import torch

    from tpfl.models import CNN as JaxCNN
    from tpfl.parallel.engine import FederationEngine as JaxEngine
    from tpfl_torch.interop import params_from_flax, params_to_numpy
    from tpfl_torch.models import CNN
    from tpfl_torch.parallel import FederationEngine

    n = 4
    x_ref, y_ref, _, _ = _ref_arrays(ref.rendered_color_digits(n_train=4 * n, n_test=2, seed=1))
    x, y, _, _ = _port_arrays(rendered_color_digits(n_train=4 * n, n_test=2, seed=1))
    assert np.array_equal(x, x_ref) and np.array_equal(y, y_ref)
    jeng = JaxEngine(JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                            compute_dtype=jnp.float32, conv_impl="pallas"),
                     n, learning_rate=0.1, seed=0)
    p0 = jax.tree_util.tree_map(np.array, dict(jeng.init_params((32, 32, 3))))
    pj, lj = jeng.run_rounds(jax.tree_util.tree_map(jnp.asarray, p0),
                             jnp.asarray(x_ref.reshape(n, 1, 4, 32, 32, 3)),
                             jnp.asarray(y_ref.reshape(n, 1, 4)), n_rounds=2)
    eng = FederationEngine(CNN(channels=(4, 8), dense=16, out_channels=10,
                               compute_dtype=torch.float32, conv_impl="pallas"),
                           n, learning_rate=0.1, seed=0, device="cpu")
    pt, lt = eng.run_rounds(params_from_flax(p0, device="cpu"), x.reshape(n, 1, 4, 32, 32, 3),
                            y.reshape(n, 1, 4), n_rounds=2)
    got, want = params_to_numpy(pt), jax.tree_util.tree_map(np.array, dict(pj))
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{layer}/{leaf}")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
