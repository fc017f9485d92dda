"""The port's data path (no OpenCV) held against OpenCV and the JAX package.

- ``data/io.py``: the PNG decoder against ``cv2.imread(..., IMREAD_COLOR)``
  on grey, RGB and RGBA PNGs that OpenCV writes at compression 0-9 and with
  each of the five row filters forced, and a grey + alpha and a palette PNG
  from PIL: bytes equal; a PNG of no colour type raises. ``.npy`` read as is; another format without OpenCV raises.
- ``data/polygon.py`` through ``data/coco.py``'s ``poly_to_mask``: against
  JAX's (``cv2.fillPoly``) on seeded polygons, convex, concave, with
  touching edges, sub-pixel, partly and wholly outside the image: pixels
  equal.
- ``CocoDataset.load_raw`` of both packages on one COCO JSON with PNG
  images (polygon, RLE and crowd GT, an image without GT): the same image
  bytes and the same GT arrays.
- The test loader against JAX's ``DataLoader`` (fixed order, last batch
  padded with ``img_id=-1`` metas); prefetch equal to sync.
"""

import sys
import zlib

import cv2
import numpy as np
import pytest

from rsprompter_tpu.data.coco import NWPUInsSegDataset as JaxNWPU
from rsprompter_tpu.data.coco import poly_to_mask as jax_poly_to_mask
from rsprompter_tpu.data.loader import DataLoader as JaxDataLoader
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data.coco import poly_to_mask
from rsprompter_tpu_torch.data.io import decode_png, imread
from rsprompter_tpu_torch.data.loader import DataLoader
from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

CLASSES = ("airplane", "ship", "storage_tank", "baseball_diamond", "tennis_court",
           "basketball_court", "ground_track_field", "harbor", "bridge", "vehicle")
PNG_FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


def _image(rng, h, w, ch):
    """Smooth blocks plus noise: every filter has something to predict."""
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, ch))
    img = np.kron(base, np.ones((4, 4, 1)))[:h, :w] + rng.integers(0, 20, (h, w, ch))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[:, :, 0] if ch == 1 else img


def _assert_same_as_cv2(path):
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = imread(str(path))
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_matches_cv2(tmp_path, channels):
    rng = np.random.default_rng(channels)
    for level in range(10):  # OpenCV's adaptive filters
        path = tmp_path / f"c{level}.png"
        cv2.imwrite(str(path), _image(rng, 37, 53, channels),
                    [cv2.IMWRITE_PNG_COMPRESSION, level])
        _assert_same_as_cv2(path)
    for name in PNG_FILTERS:  # each row filter alone
        path = tmp_path / f"f{name}.png"
        cv2.imwrite(str(path), _image(rng, 21, 19, channels),
                    [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{name}")])
        kinds = _filter_bytes(path.read_bytes())
        assert kinds == {PNG_FILTERS.index(name)}, kinds
        _assert_same_as_cv2(path)


def _filter_bytes(data):
    import zlib

    from rsprompter_tpu_torch.data.io import _chunks

    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    hdr = next(body for kind, body in _chunks(data) if kind == b"IHDR")
    h = int.from_bytes(hdr[4:8], "big")
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


def test_png_grey_alpha_and_refusals(tmp_path):
    from PIL import Image

    la = np.random.default_rng(0).integers(0, 256, (20, 30, 2)).astype(np.uint8)
    Image.fromarray(la, "LA").save(tmp_path / "la.png")
    _assert_same_as_cv2(tmp_path / "la.png")
    Image.fromarray(la[:, :, 0], "L").convert("P").save(tmp_path / "palette.png")
    _assert_same_as_cv2(tmp_path / "palette.png")  # palette PNGs are decoded now
    data = bytearray((tmp_path / "palette.png").read_bytes())
    data[25] = 5  # IHDR's colour type: 5 is no PNG colour type
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="colour type 5"):
        imread(str(tmp_path / "bad.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def test_npy_and_other_formats(tmp_path, monkeypatch):
    arr = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(imread(str(tmp_path / "a.npy")), arr)
    img = _image(np.random.default_rng(0), 16, 24, 3)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    _assert_same_as_cv2(tmp_path / "a.jpg")
    _assert_same_as_cv2(tmp_path / "a.bmp")  # through OpenCV where it imports
    ref = cv2.imread(str(tmp_path / "a.jpg"), cv2.IMREAD_COLOR)
    monkeypatch.setitem(sys.modules, "cv2", None)  # a machine without OpenCV
    # JPEG through the port's own decoder, equal to OpenCV's
    np.testing.assert_array_equal(imread(str(tmp_path / "a.jpg")), ref)
    with pytest.raises(ValueError, match="no decoder"):
        imread(str(tmp_path / "a.bmp"))


def _polygons(kind, rng, h, w):
    n = int(rng.integers(3, 10))
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, min(h, w) / 2)
        return [np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1).ravel()]
    if kind == "concave":  # star-shaped, radii far apart
        ang = np.sort(rng.uniform(0, 2 * np.pi, n + 3))
        r = rng.uniform(1, min(h, w) / 2, n + 3)
        return [np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1).ravel()]
    if kind == "touching":  # self-crossing, repeated vertices, two parts sharing an edge
        a = rng.uniform(0, [w, h], (n, 2))
        b = np.concatenate([a[:2][::-1], rng.uniform(0, [w, h], (3, 2))])
        return [np.concatenate([a, a[:1]]).ravel(), b.ravel()]
    if kind == "subpixel":
        c = rng.uniform(2, [w - 2, h - 2])
        return [(c + rng.uniform(-1.6, 1.6, (n, 2))).ravel()]
    if kind == "outside":  # partly, then wholly, outside the image
        lo, hi = [-0.5 * w, -0.5 * h], [1.5 * w, 1.5 * h]
        return [rng.uniform(lo, hi, (n, 2)).ravel() for _ in range(int(rng.integers(1, 3)))]
    if kind == "far":
        return [rng.uniform([-4 * w, -4 * h], [5 * w, 5 * h], (n, 2)).ravel()]
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["convex", "concave", "touching", "subpixel", "outside", "far"])
def test_poly_to_mask_matches_cv2(kind):
    rng = np.random.default_rng(["convex", "concave", "touching", "subpixel", "outside",
                                 "far"].index(kind))
    for trial in range(150):
        h, w = (int(v) for v in rng.integers(6, 70, 2))
        polys = [p.tolist() for p in _polygons(kind, rng, h, w)]
        got = poly_to_mask(polys, h, w)
        ref = jax_poly_to_mask(polys, h, w)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref), (trial, h, w, polys, np.argwhere(got != ref)[:8])


def test_poly_to_mask_large():
    """NWPU-sized polygons on a 1000 x 900 image."""
    rng = np.random.default_rng(9)
    for _ in range(4):
        polys = [p.tolist() for p in _polygons("concave", rng, 1000, 900)]
        polys[0] = (np.asarray(polys[0]) * 3 - 600).tolist()  # far past the edges too
        np.testing.assert_array_equal(poly_to_mask(polys, 1000, 900),
                                      jax_poly_to_mask(polys, 1000, 900))


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return synthetic_coco(str(tmp_path_factory.mktemp("coco")), CLASSES,
                          ((64, 80), (70, 64), (64, 64), (90, 60), (72, 66)), cv2.imwrite, seed=3)


def _datasets(coco_dir):
    kw = dict(ann_file="ann.json", data_root=coco_dir, data_prefix=dict(img="imgs"),
              test_mode=True)
    port = DATASETS.build(dict(type="NWPUInsSegDataset", **kw))
    return port, JaxNWPU(**kw)


def test_load_raw_matches_jax(coco_dir):
    port, ref = _datasets(coco_dir)
    assert len(port) == len(ref) == 5 and port.metainfo["classes"] == CLASSES
    kinds = set()
    for i in range(len(ref)):
        got, want = port.load_raw(i), ref.load_raw(i)
        assert got.keys() == want.keys()
        assert got["img"].dtype == np.uint8
        np.testing.assert_array_equal(got["img"].astype(np.float32), want["img"])
        for k, v in want.items():
            if k != "img":
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        kinds.add(len(want["gt_labels"]) == 0)
        kinds.add("crowd" if want["gt_ignore_flags"].any() else "no crowd")
    assert kinds == {True, False, "crowd", "no crowd"}
    anns = [a for d in ref.data_list for a in d["anns"]]
    assert {type(a["segmentation"]).__name__ for a in anns} == {"list", "dict"}


@pytest.mark.parametrize("batch_size", [2, 3])
def test_loader_matches_jax(coco_dir, batch_size):
    port, ref = _datasets(coco_dir)
    sync = list(DataLoader(port, batch_size=batch_size))
    ahead = list(DataLoader(port, batch_size=batch_size, prefetch=2))
    want = list(JaxDataLoader(ref, batch_size=batch_size, shuffle=False, drop_last=False,
                              pad_shape=(96, 96)))
    assert len(sync) == len(ahead) == len(want) == len(DataLoader(port, batch_size))
    for (samples, metas), (s2, m2), (batch, jmetas) in zip(sync, ahead, want):
        assert metas == m2 and len(metas) == batch_size
        assert [m["img_id"] for m in metas] == [m["img_id"] for m in jmetas]
        for m, j in zip(metas, jmetas):
            assert m == {k: j[k] for k in m}
        for i, (s, t) in enumerate(zip(samples, s2)):
            np.testing.assert_array_equal(s["img"], t["img"])
            h, w = s["img"].shape[:2]
            np.testing.assert_array_equal(s["img"].astype(np.float32),
                                          batch["images"][i, :h, :w])
    assert sync[-1][1][-1]["img_id"] == -1


def test_loader_prefetch_raises_the_workers_error(coco_dir):
    port, _ = _datasets(coco_dir)
    port.data_list[3]["img_path"] += ".missing"
    with pytest.raises(FileNotFoundError):
        list(DataLoader(port, batch_size=2, prefetch=1))
