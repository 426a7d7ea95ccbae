"""The port's data modules against the JAX package's on the CPU: flow and
image I/O, the native host library's binding, and every dataset class's
index builder and sample reader on synthetic trees (the MPF and FlowScape
trees of ``tests/test_data.py``, the other layouts as
``tests/test_datasets_all.py`` builds them).

Tolerances: none. File I/O, index lists and samples are compared bitwise,
and each native function against the JAX binding's on one library, then
on both numpy fallbacks.
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest

from prior_flow_tpu.data import datasets as jds
from prior_flow_tpu.data import frame_utils as jfu
from prior_flow_tpu.data import native as jnative
from prior_flow_tpu_torch.data import datasets as tds
from prior_flow_tpu_torch.data import frame_utils as tfu
from prior_flow_tpu_torch.data import native as tnative
from test_data import _make_flowscape_tree, _make_mpf_tree
from test_datasets_all import H, W, _flo, _img, _npy_flow, _pfm_flow


def _same(a, b):
    """Bitwise equality of two samples (tuples of arrays and metadata)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)
        else:
            assert x == y


def _same_dataset(j, t):
    assert len(j) == len(t)
    assert j.image_list == t.image_list
    assert j.flow_list == t.flow_list
    assert j.extra_info == t.extra_info
    assert j.is_test == t.is_test and j.sparse == t.sparse
    assert j.wrap_u == t.wrap_u
    for i in range(len(j)):
        _same(j[i], t[i])


# -- frame I/O --------------------------------------------------------------------

def test_flo_round_trips_both_ways(rng, tmp_path):
    flow = (rng.normal(size=(17, 23, 2)) * 10).astype(np.float32)
    p, q = str(tmp_path / "t.flo"), str(tmp_path / "j.flo")
    tfu.write_flo(p, flow)
    jfu.write_flo(q, flow)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert np.array_equal(jfu.read_flo(p), flow)
    assert np.array_equal(tfu.read_flo(q), flow)
    with open(p, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(ValueError):
        tfu.read_flo(p)


@pytest.mark.parametrize("color", [False, True])
def test_read_pfm_matches_jax(rng, tmp_path, color):
    shape = (8, 12, 3) if color else (8, 12)
    data = rng.normal(size=shape).astype(np.float32)
    p = str(tmp_path / "d.pfm")
    with open(p, "wb") as f:
        f.write(b"PF\n12 8\n-1.0\n" if color else b"Pf\n12 8\n-1.0\n")
        np.flipud(data).astype("<f").tofile(f)
    got = tfu.read_pfm(p)
    assert np.array_equal(got, jfu.read_pfm(p))
    assert np.array_equal(got, data)
    _same([tfu.read_gen(p)], [jfu.read_gen(p)])


def test_kitti_flow_and_disparity_match_jax(rng, tmp_path):
    import cv2
    flow = (rng.normal(size=(16, 24, 2)) * 5).astype(np.float32)
    p, q = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tfu.write_flow_kitti(p, flow)
    jfu.write_flow_kitti(q, flow)
    _same(tfu.read_flow_kitti(p), jfu.read_flow_kitti(q))
    _same(tfu.read_flow_kitti(q), jfu.read_flow_kitti(p))
    disp = str(tmp_path / "disp.png")
    cv2.imwrite(disp, rng.integers(0, 2 ** 16, (16, 24)).astype(np.uint16))
    _same(tfu.read_disp_kitti(disp), jfu.read_disp_kitti(disp))


@pytest.mark.parametrize("ext", [".png", ".jpg", ".ppm"])
@pytest.mark.parametrize("channels", [0, 3])
def test_images_written_by_the_port_read_alike(rng, tmp_path, ext, channels):
    """``write_image`` output read by both packages, and a cv2-written
    colour file (BGR order on disk) read by both, bitwise."""
    import cv2
    shape = (H, W, channels) if channels else (H, W)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / ("port" + ext))
    tfu.write_image(p, img)
    _same([tfu.read_gen(p)], [jfu.read_gen(p)])
    if ext == ".png":
        assert np.array_equal(tfu.read_image(p), img)
    if channels:                  # cv2 writes no grey .ppm
        q = str(tmp_path / ("cv2" + ext))
        assert cv2.imwrite(q, img)
        _same([tfu.read_image(q)], [jfu.read_image(q)])


def test_read_gen_dispatch_matches_jax(rng, tmp_path):
    flow = rng.normal(size=(6, 8, 2)).astype(np.float32)
    p, n = str(tmp_path / "x.flo"), str(tmp_path / "y.npy")
    tfu.write_flo(p, flow)
    np.save(n, flow)
    for path in (p, n):
        _same([tfu.read_gen(path)], [jfu.read_gen(path)])
    assert tfu.read_gen(str(tmp_path / "z.txt")) == []


def test_missing_codecs_raise_naming_them(tmp_path, monkeypatch):
    """Without PIL and cv2 an image read or write raises an ImportError
    that names both, and a KITTI read names cv2: nothing falls back."""
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tfu, "_pil_image", lambda: None)
    p = str(tmp_path / "a.png")
    with pytest.raises(ImportError, match="PIL or cv2"):
        tfu.write_image(p, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError, match="PIL or cv2"):
        tfu.read_image(p)
    with pytest.raises(ImportError, match="cv2"):
        tfu.read_flow_kitti(p)


# -- the native host library ---------------------------------------------------

@pytest.fixture(scope="module")
def built_lib(tmp_path_factory):
    """The port's binding to a library it compiled itself, outside
    ``native/``."""
    path = tnative.build(str(tmp_path_factory.mktemp("native")))
    assert osp.dirname(path) != osp.dirname(tnative.DEFAULT_LIB)
    return tnative._bind(path)


@pytest.fixture(params=["library", "numpy"])
def port_native(request, built_lib, monkeypatch):
    """The port's native module and the JAX package's, both on one built
    library, then both on their numpy fallbacks."""
    if request.param == "library":
        monkeypatch.setattr(tnative, "_lib", built_lib)
        monkeypatch.setattr(jnative, "_lib", built_lib)
    else:
        monkeypatch.setattr(tnative, "load", lambda path=None: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    assert tnative.available() == jnative.available() == (
        request.param == "library")
    return tnative


@pytest.mark.parametrize("wrap_u", [False, True])
def test_native_read_flo_matches_jax(rng, tmp_path, port_native, wrap_u):
    flow = (rng.normal(size=(13, 32, 2)) * 60).astype(np.float32)
    p = str(tmp_path / "t.flo")
    tfu.write_flo(p, flow)
    assert np.array_equal(port_native.read_flo(p, wrap_u=wrap_u),
                          jnative.read_flo(p, wrap_u=wrap_u))


def test_native_roll_and_eraser_match_jax(rng, port_native):
    img = rng.integers(0, 255, (16, 32, 3)).astype(np.uint8)
    arr = rng.normal(size=(8, 16, 2)).astype(np.float32)
    for k in (0, 5, -7, 32, 45, -33):
        assert np.array_equal(port_native.roll(img, k), jnative.roll(img, k))
        assert np.array_equal(port_native.roll(arr, k), jnative.roll(arr, k))
    assert np.array_equal(port_native.mean_color(img),
                          jnative.mean_color(img))
    color = port_native.mean_color(img)
    for rect in ((5, 3, 10, 6), (28, 12, 10, 10)):
        a, b = img.copy(), img.copy()
        port_native.erase_rect(a, *rect, color)
        jnative.erase_rect(b, *rect, color)
        assert np.array_equal(a, b)


def test_native_bad_file_raises(tmp_path, port_native):
    p = str(tmp_path / "bad.flo")
    with open(p, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(ValueError):
        port_native.read_flo(p)


# -- datasets ------------------------------------------------------------------

def test_mpf_flowscape_and_city_match_jax(tmp_path):
    """The MPF test split (reversed pairs, backward flow), its City twin,
    both scenes together, and FlowScape: the same index lists and the
    same samples, bitwise."""
    mpf = _make_mpf_tree(str(tmp_path / "mpf"), n=4, H=16, W=32)
    shutil.copytree(osp.join(mpf, "EFTs_Car100"), osp.join(mpf, "City_100_r"))
    for scene in ("EFT", "City", "all"):
        _same_dataset(jds.MPFDataset(split="test", scene=scene, root=mpf),
                      tds.MPFDataset(split="test", scene=scene, root=mpf))
    fs = _make_flowscape_tree(str(tmp_path / "fs"), n=3, H=16, W=32)
    j = jds.FlowScape(split="test", scene="sunny", root=fs)
    t = tds.FlowScape(split="test", scene="sunny", root=fs)
    _same_dataset(j, t)
    assert len(t) == 2


def test_u_wrap_of_the_360_datasets(tmp_path):
    root = _make_mpf_tree(str(tmp_path), n=2, H=16, W=32)
    d = tds.MPFDataset(split="test", scene="EFT", root=root)
    flow = np.zeros((16, 32, 2), np.float32)
    flow[..., 0] = 30.0           # > W/2 = 16: wraps to -2
    tfu.write_flo(d.flow_list[0], flow)
    img1, img2, out, valid = d[0]
    assert np.all(out[..., 0] == -2.0)
    assert img1.dtype == np.float32 and valid.dtype == np.float32


def _flow360(root):
    for clip in ("clipA", "clipB"):
        for i in range(4):
            _img(osp.join(root, "train", clip, "frames", f"{i:04d}.png"), i)
        for i in range(3):
            _npy_flow(osp.join(root, "train", clip, "fflows",
                               f"{i:04d}.npy"), u0=W - 1.0)
    return dict(split="train", root=root)


def _omniflownet(root):
    for sc in jds.OmniFlowNetDataset.SCENES:
        for i in range(3):
            _img(osp.join(root, sc, "seq1", "images", f"{i:04d}.png"), i)
            _flo(osp.join(root, sc, "seq1", "ground_truth", f"{i:04d}.flo"), i)
    return dict(root=root, scene="Forest")


def _omniphotos(root):
    for i in range(3):
        _img(osp.join(root, "sceneA", "Input", f"{i:04d}.jpg"), i)
    return dict(root=root)


def _odvista(root):
    for i in range(3):
        _img(osp.join(root, "train", "LR_X2", "g0", "vid1", f"{i:04d}.png"), i)
    return dict(split="train", root=root, resolution="x2")


def _panovos(root):
    for i in range(4):
        _img(osp.join(root, "val", "JPEGImages", "clip0", f"{i:04d}.jpg"), i)
    return dict(split="val", root=root)


def _sintel(split):
    def build(root):
        for scene in ("alley_1", "ambush_2"):
            for i in range(3):
                _img(osp.join(root, split, "clean", scene,
                              f"frame_{i:04d}.png"), i)
            for i in range(2):
                _flo(osp.join(root, split, "flow", scene,
                              f"frame_{i:04d}.flo"), i)
        return dict(split=split, root=root, dstype="clean")
    return build


def _chairs(root):
    for i in range(4):
        _img(osp.join(root, f"{i:05d}_img1.ppm"), 2 * i)
        _img(osp.join(root, f"{i:05d}_img2.ppm"), 2 * i + 1)
        _flo(osp.join(root, f"{i:05d}_flow.flo"), i)
    split_file = osp.join(root, "chairs_split.txt")
    np.savetxt(split_file, np.array([1, 2, 1, 2]), fmt="%d")
    return dict(split="validation", root=root, split_file=split_file)


def _things(root):
    seq = "TRAIN/A/0000"
    for i in range(3):
        _img(osp.join(root, "frames_cleanpass", seq, "left", f"{i:04d}.png"), i)
    for d in ("into_future", "into_past"):
        for i in range(3):
            _pfm_flow(osp.join(root, "optical_flow", seq, d, "left",
                               f"{i:04d}.pfm"), i)
    return dict(root=root, dstype="frames_cleanpass")


def _kitti(split, imgdir):
    def build(root):
        rng = np.random.RandomState(0)
        os.makedirs(osp.join(root, split, "flow_occ"))
        for i in range(2):
            _img(osp.join(root, split, imgdir, f"{i:06d}_10.png"), i)
            _img(osp.join(root, split, imgdir, f"{i:06d}_11.png"), i)
            tfu.write_flow_kitti(
                osp.join(root, split, "flow_occ", f"{i:06d}_10.png"),
                rng.uniform(-10, 10, (H, W, 2)).astype(np.float32))
        return dict(split=split, root=root)
    return build


def _hd1k(root):
    rng = np.random.RandomState(0)
    os.makedirs(osp.join(root, "hd1k_flow_gt", "flow_occ"))
    for seq in range(2):
        for i in range(3):
            _img(osp.join(root, "hd1k_input", "image_2",
                          f"{seq:06d}_{i:04d}.png"), i)
            tfu.write_flow_kitti(
                osp.join(root, "hd1k_flow_gt", "flow_occ",
                         f"{seq:06d}_{i:04d}.png"),
                rng.uniform(-5, 5, (H, W, 2)).astype(np.float32))
    return dict(root=root)


FAMILIES = [
    ("Flow360", _flow360), ("OmniFlowNetDataset", _omniflownet),
    ("OmniPhotos", _omniphotos), ("ODVista", _odvista),
    ("PanoVOS", _panovos), ("MpiSintel", _sintel("training")),
    ("MpiSintel", _sintel("test")), ("FlyingChairs", _chairs),
    ("FlyingThings3D", _things), ("KITTI", _kitti("training", "image_2")),
    ("KITTI", _kitti("testing", "image_2")),
    ("KITTI12", _kitti("training", "colored_0")), ("HD1K", _hd1k)]


@pytest.mark.parametrize("name,build", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
def test_dataset_family_matches_jax(tmp_path, name, build):
    """Every other dataset class: the same index lists, the same test-only
    flag and extra info, and the same samples, bitwise."""
    kw = build(str(tmp_path / name))
    j, t = getattr(jds, name)(**kw), getattr(tds, name)(**kw)
    assert len(t) > 0
    _same_dataset(j, t)


def test_aug_params_raise_naming_the_next_slice(tmp_path):
    root = _make_mpf_tree(str(tmp_path), n=2, H=16, W=32)
    with pytest.raises(NotImplementedError, match="training-data slice"):
        tds.MPFDataset({"do_flip": False}, split="test", scene="EFT",
                       root=root)
