"""The port's data modules against the JAX package's on the CPU: flow and
image I/O, the native host library's binding, every dataset class's index
lists and sample reader on synthetic trees (the MPF and FlowScape trees
of ``tests/test_data.py``, the other layouts as
``tests/test_datasets_all.py`` builds them), the augmentors, the augmented
training split, the batch loader and the factory.

Tolerances: none. File I/O, index lists, samples, augmented samples and
batches are compared bitwise; each native function and each augmentor
against the JAX package's on one library, then on both numpy fallbacks.
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
    """``aug_params`` once raised, naming the slice that would port the
    augmentors; that slice is here. Each base now builds the JAX package's
    augmentor class with the same settings: 360° dense and sparse,
    perspective dense and sparse."""
    root = _make_mpf_tree(str(tmp_path), n=2, H=16, W=32)
    aug = {"do_flip": False}
    pairs = [(jds.MPFDataset(aug, split="test", scene="EFT", root=root),
              tds.MPFDataset(aug, split="test", scene="EFT", root=root))]
    crop = {"crop_size": (8, 16)}
    for base, sparse, kw in (("FlowDataset", False, crop),
                             ("FlowDataset", True, crop),
                             ("FlowDataset360", False, aug),
                             ("FlowDataset360", True, crop)):
        pairs.append((getattr(jds, base)(kw, sparse=sparse),
                      getattr(tds, base)(kw, sparse=sparse)))
    for j, t in pairs:
        assert type(t.augmentor).__name__ == type(j.augmentor).__name__
        strip = lambda a: {k: v for k, v in vars(a).items() if k != "rng"}
        assert strip(t.augmentor) == strip(j.augmentor)
    assert tds.MPFDataset(split="test", scene="EFT",
                          root=root).augmentor is None


# -- the augmentors ----------------------------------------------------------------

AH, AW, CROP = 64, 128, (48, 96)

# (class, constructor arguments, probabilities forced on the instance)
AUG_CASES = [
    ("FlowAugmentor360", {}, dict(asymmetric_color_aug_prob=0.0,
                                  eraser_aug_prob=0.0, rotation_aug_prob=1.0)),
    ("FlowAugmentor360", {}, dict(asymmetric_color_aug_prob=1.0,
                                  eraser_aug_prob=1.0, rotation_aug_prob=1.0,
                                  asymmetric_rotation_aug_prob=1.0)),
    ("FlowAugmentor360", {}, dict(rotation_aug_prob=0.0)),
    ("FlowAugmentor", dict(crop_size=CROP, do_flip=True),
     dict(h_flip_prob=1.0, v_flip_prob=1.0, stretch_prob=1.0,
          spatial_aug_prob=1.0, asymmetric_color_aug_prob=1.0,
          eraser_aug_prob=1.0)),
    ("FlowAugmentor", dict(crop_size=CROP, do_flip=True),
     dict(h_flip_prob=0.0, v_flip_prob=0.0, stretch_prob=0.0,
          spatial_aug_prob=0.0, asymmetric_color_aug_prob=0.0,
          eraser_aug_prob=0.0)),
    ("SparseFlowAugmentor", dict(crop_size=CROP, do_flip=True),
     dict(spatial_aug_prob=1.0, eraser_aug_prob=1.0)),
    ("SparseFlowAugmentor", dict(crop_size=CROP, do_flip=False),
     dict(spatial_aug_prob=0.0, eraser_aug_prob=0.0)),
    ("SparseFlowAugmentor360", dict(crop_size=CROP),
     dict(spatial_aug_prob=1.0)),
    ("FlowAugmentor360Ortho", {}, dict(asymmetric_color_aug_prob=1.0,
                                       eraser_aug_prob=1.0,
                                       rotation_aug_prob=1.0)),
    ("SparseFlowAugmentor360Ortho", dict(crop_size=CROP),
     dict(spatial_aug_prob=1.0, eraser_aug_prob=1.0)),
]


def _aug_inputs(seed, cls_name):
    """Uint8 frames, a float32 flow, a 0/1 validity for the sparse
    classes, and the two orthogonal views for the ortho classes."""
    rng = np.random.default_rng(100 + seed)
    img = lambda: rng.integers(0, 256, (AH, AW, 3), dtype=np.uint8)
    args = [img(), img(), (rng.normal(size=(AH, AW, 2)) * 10).astype(
        np.float32)]
    if "Sparse" in cls_name:
        args.append((rng.uniform(size=(AH, AW)) > 0.3).astype(np.float32))
    if "Ortho" in cls_name:
        args += [img(), img()]
    return args


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(AUG_CASES)),
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(AUG_CASES)])
def test_augmentors_match_jax(port_native, case, seed):
    """Every augmentor class under the same RandomState, with each
    probability branch forced on and off: the same images, flow and
    validity, bitwise, on the native library and on the numpy
    fallbacks."""
    from prior_flow_tpu.data import augmentor as jaug
    from prior_flow_tpu_torch.data import augmentor as taug
    name, kw, probs = AUG_CASES[case]
    j, t = getattr(jaug, name)(**kw), getattr(taug, name)(**kw)
    for k, v in probs.items():
        setattr(j, k, v)
        setattr(t, k, v)
    args = _aug_inputs(seed, name)
    ref = j(*[a.copy() for a in args], rng=np.random.RandomState(seed))
    got = t(*[a.copy() for a in args], rng=np.random.RandomState(seed))
    _same(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_augmentor_functions_and_methods_match_jax(port_native, seed):
    """``color_jitter`` (each op alone and all four), ``_eraser``,
    ``u_clip_np``, and the 360° augmentor's flip and resize methods, which
    its ``__call__`` leaves out."""
    from prior_flow_tpu.data import augmentor as jaug
    from prior_flow_tpu_torch.data import augmentor as taug
    img1, img2, flow = _aug_inputs(seed, "FlowAugmentor360")
    for kw in (dict(brightness=0.4, contrast=0, saturation=0, hue=0),
               dict(brightness=0, contrast=0.4, saturation=0, hue=0),
               dict(brightness=0, contrast=0, saturation=0.4, hue=0),
               dict(brightness=0, contrast=0, saturation=0, hue=0.2),
               {}):
        _same([taug.color_jitter(img1, rng=np.random.RandomState(seed), **kw)],
              [jaug.color_jitter(img1, rng=np.random.RandomState(seed), **kw)])
    _same(taug._eraser(img1.copy(), img2.copy(), (5, 30), 1.0,
                       np.random.RandomState(seed)),
          jaug._eraser(img1.copy(), img2.copy(), (5, 30), 1.0,
                       np.random.RandomState(seed)))
    u = np.linspace(-300, 300, 97).astype(np.float32)
    _same([taug.u_clip_np(u, AW)], [jaug.u_clip_np(u, AW)])
    j = jaug.FlowAugmentor360(resize_size=(32, 96), do_flip=True)
    t = taug.FlowAugmentor360(resize_size=(32, 96), do_flip=True)
    for a in (j, t):
        a.h_flip_prob = a.v_flip_prob = 1.0
    _same(t.flip_transform(img1, img2, flow, rng=np.random.RandomState(seed)),
          j.flip_transform(img1, img2, flow, rng=np.random.RandomState(seed)))
    _same(t.resize_transform(img1, img2, flow),
          j.resize_transform(img1, img2, flow))


def _train_tree(root, n=5, h=AH, w=AW):
    """``_make_mpf_tree`` as the EFT training split."""
    _make_mpf_tree(root, n=n, H=h, W=w)
    os.rename(osp.join(root, "EFTs_Car100"), osp.join(root, "EFTs_Car2000"))
    return root


def test_fetch_dataset_eft_matches_jax(tmp_path, port_native):
    """``fetch_dataset("EFT")``'s augmented samples, every index, epochs 0
    and 1, bitwise."""
    root = _train_tree(str(tmp_path))
    j, t = jds.fetch_dataset("EFT", root), tds.fetch_dataset("EFT", root)
    assert len(t) == len(j) == 4
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in range(len(t)):
            _same(t[i], j[i])
    t.set_epoch(0)
    assert not np.array_equal(t[0][0], j[0][0])   # j is at epoch 1
    with pytest.raises(ValueError, match="stage"):
        tds.fetch_dataset("Sintel", root)


# -- the loader and the factory --------------------------------------------------

def _take(stream, n):
    """The first ``n`` batches of a stream as numpy tuples; the stream is
    closed after (its workers or producer stop)."""
    import itertools
    try:
        return [tuple(np.asarray(x) for x in b)
                for b in itertools.islice(stream, n)]
    finally:
        stream.close()


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_batch_sequence_matches_jax(tmp_path, workers):
    """The loader's batches against the JAX ``DataLoader``'s, bitwise, at
    32x64: the infinite stream across two epoch boundaries (the epoch
    travels with each index into the worker processes), a resume at batch
    3, successive ``iter()`` calls, both shards of a two-way split without
    ``drop_last`` (a short batch), and the error of an empty loader."""
    from prior_flow_tpu.data.loader import DataLoader as JLoader
    from prior_flow_tpu_torch.data.loader import DataLoader as TLoader
    root = _train_tree(str(tmp_path), n=6, h=32, w=64)
    jd, td = jds.fetch_dataset("EFT", root), tds.fetch_dataset("EFT", root)
    jl = JLoader(jd, batch_size=2, num_workers=workers)
    tl = TLoader(td, batch_size=2, num_workers=workers)
    assert len(tl) == len(jl) == 2
    _same_batches(_take(tl.infinite(), 5), _take(jl.infinite(), 5))
    _same_batches(_take(tl.infinite(start_batch=3), 3),
                  _take(jl.infinite(start_batch=3), 3))
    for _ in range(2):
        _same_batches(_take(iter(tl), 5), _take(iter(jl), 5))
    for shard in (0, 1):
        kw = dict(batch_size=3, num_workers=workers, drop_last=False,
                  num_shards=2, shard_index=shard)
        j, t = JLoader(jd, **kw), TLoader(td, **kw)
        assert len(t) == len(j) == 1          # one short batch of 2
        _same_batches(_take(iter(t), 5), _take(iter(j), 5))
    for loader in (JLoader(jd, batch_size=8), TLoader(td, batch_size=8)):
        with pytest.raises(ValueError, match="0 batches"):
            next(loader.infinite())


def test_factory_matches_jax(tmp_path):
    """``build_dataset`` of two MPF training splits: a ``ConcatDataset``
    with the same length and samples at every index (modulo its length);
    ``build_dataloader``'s per-shard batch and its first epoch."""
    from prior_flow_tpu.data import factory as jf
    from prior_flow_tpu_torch.data import factory as tf
    root = _train_tree(str(tmp_path), n=4, h=32, w=64)
    kw = dict(name=("MPFDataset", "MPFDataset"), scene="EFT",
              aug_params={"do_flip": False}, batch_size=4, num_shards=2,
              num_workers=1, roots={"MPFDataset": root})
    j = jf.build_dataset(jf.DataConfig(**kw))
    t = tf.build_dataset(tf.DataConfig(**kw))
    assert isinstance(t, tf.ConcatDataset) and len(t) == len(j) == 6
    assert t._offsets == j._offsets
    for i in range(len(t) + 2):
        _same(t[i], j[i])
    jl = jf.build_dataloader(jf.DataConfig(**kw))
    tl = tf.build_dataloader(tf.DataConfig(**kw))
    assert tl.batch_size == jl.batch_size == 2
    _same_batches(_take(iter(tl), 4), _take(iter(jl), 4))
