"""Port parity for the data path of the NGP entry point: the transforms.json
loader against `tngp.data.provider.NeRFDataset.load` on blender and colmap
fixtures whose PNGs `cv2` wrote, the port's PNG codec against `cv2`,
`rand_poses`, the colour conversions, SSIM, and mesh extraction against the
JAX package's native wrapper."""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from tngp.data import provider as jprov
from tngp.native import marching_tetrahedra as jax_marching_tetrahedra
from tngp.native import save_ply as jax_save_ply
from tngp.train.metrics import ssim as jax_ssim
from tngp.utils.colors import linear_to_srgb as jax_linear_to_srgb
from tngp.utils.colors import srgb_to_linear as jax_srgb_to_linear
from tngp_torch.data import provider as tprov
from tngp_torch.native import marching_tetrahedra, save_ply
from tngp_torch.train.metrics import LPIPSMeter, SSIMMeter, ssim
from tngp_torch.utils import image_io
from tngp_torch.utils.colors import linear_to_srgb, srgb_to_linear


def _smooth_image(rng, H, W, C):
    """Smooth content, so that libpng's adaptive filters vary."""
    img = rng.integers(0, 256, (H, W, C)).astype(np.int64)
    img = np.cumsum(np.cumsum(img, axis=0), axis=1) // (H * 6)
    return (img % 256).astype(np.uint8)


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.normal(0, 2, 3)
    return m.tolist()


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    """RGBA frames, no extension in file_path, camera_angle_x only; H = 21
    is odd, so downscale 2 takes the area weights' general path."""
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("test", 2)):
        (root / split).mkdir()
        frames = []
        for i in range(n):
            bgra = _smooth_image(rng, 21, 30, 4)
            cv2.imwrite(str(root / split / f"r_{i}.png"), bgra)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": _pose(rng)})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return str(root)


@pytest.fixture(scope="module")
def colmap(tmp_path_factory):
    """RGB frames listed out of order, explicit fl_x/fl_y/cx/cy/w/h: the
    sort by file path and the 1/8 holdout."""
    root = tmp_path_factory.mktemp("colmap")
    (root / "images").mkdir()
    rng = np.random.default_rng(1)
    frames = []
    for i in rng.permutation(10):
        cv2.imwrite(str(root / "images" / f"{i:04d}.png"), _smooth_image(rng, 24, 32, 3))
        frames.append({"file_path": f"images/{i:04d}.png", "transform_matrix": _pose(rng)})
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": 40.5, "fl_y": 41.0, "cx": 15.5, "cy": 12.25, "w": 32, "h": 24,
         "frames": frames}))
    return str(root)


@pytest.mark.parametrize("which,split,downscale", [
    ("blender", "train", 1), ("blender", "test", 1), ("blender", "train", 2),
    ("colmap", "train", 1), ("colmap", "val", 1), ("colmap", "test", 2),
])
def test_loader_matches_jax(blender, colmap, which, split, downscale):
    """Poses, intrinsics, sizes and splits exact; images exact at downscale
    1 and within 1/255 at downscale 2 (cv2's INTER_AREA rounds its float
    area sums its own way)."""
    root = blender if which == "blender" else colmap
    kw = dict(split=split, downscale=downscale, scale=0.8, offset=(0.1, -0.2, 0.3))
    want = jprov.NeRFDataset.load(root, **kw)
    got = tprov.NeRFDataset.load(root, **kw)
    assert (got.H, got.W) == (want.H, want.W)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    assert got.images.shape == want.images.shape and got.images.dtype == np.float32
    if downscale == 1:
        np.testing.assert_array_equal(got.images, want.images)
    else:
        np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1.0 / 255 + 1e-7)
    n = {"blender": {"train": 3, "test": 2}, "colmap": {"train": 8, "val": 2, "test": 2}}
    assert got.num_frames == n[which][split]
    if which == "blender":  # no transforms_val.json: both packages raise
        for load in (jprov.NeRFDataset.load, tprov.NeRFDataset.load):
            with pytest.raises(FileNotFoundError):
                load(root, split="val")


def _png_with_filters(img, filters):
    """Encode uint8 [H, W, C] with the given per-row filter types (0-4)."""
    H, W, C = img.shape
    raw = bytearray()
    prior = np.zeros(W * C, np.int64)
    for y in range(H):
        row = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(C, np.int64), row[:-C]])
        up_left = np.concatenate([np.zeros(C, np.int64), prior[:-C]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        raw.append(f)
        raw += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ctype = {1: 0, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_against_cv2(tmp_path, channels):
    """Every row filter (0-4) decodes as cv2 decodes it; a write/read round
    trip is exact; a 16-bit PNG is refused."""
    rng = np.random.default_rng(channels)
    img = _smooth_image(rng, 13, 17, channels)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4, 3, 4]))
    got = image_io.read_png(str(path))
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if channels == 1:
        np.testing.assert_array_equal(got, img[..., 0])
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_array_equal(got, img)
        code = cv2.COLOR_BGR2RGB if channels == 3 else cv2.COLOR_BGRA2RGBA
        np.testing.assert_array_equal(got, cv2.cvtColor(ref, code))
    out = tmp_path / "g.png"
    image_io.write_png(str(out), got)
    np.testing.assert_array_equal(image_io.read_png(str(out)), got)
    np.testing.assert_array_equal(cv2.imread(str(out), cv2.IMREAD_UNCHANGED), ref)
    cv2.imwrite(str(tmp_path / "h.png"), (img.astype(np.uint16) * 257)[..., 0])
    with pytest.raises(ValueError, match="unsupported PNG"):
        image_io.read_png(str(tmp_path / "h.png"))


def test_rand_poses_colors_and_ssim():
    """`rand_poses` exact for one generator state; the colour conversions
    exact on numpy; SSIM to 1e-12 (the same scipy filter)."""
    for size, radius in ((5, 1.0), (3, 2.5)):
        want = jprov.rand_poses(np.random.default_rng(7), size, radius=radius)
        got = tprov.rand_poses(np.random.default_rng(7), size, radius=radius)
        np.testing.assert_array_equal(got, want)
    x = np.linspace(-0.1, 1.1, 1001).astype(np.float32)
    np.testing.assert_array_equal(srgb_to_linear(x), jax_srgb_to_linear(x))
    np.testing.assert_array_equal(linear_to_srgb(x), jax_linear_to_srgb(x))
    rng = np.random.default_rng(3)
    a, b = rng.uniform(size=(20, 24, 3)), rng.uniform(size=(20, 24, 3))
    assert abs(ssim(a, b) - jax_ssim(a, b)) < 1e-12
    m = SSIMMeter()
    m.update(a, a)
    assert abs(m.measure() - 1.0) < 1e-12


def test_lpips_shim_reports_nothing_it_did_not_compute():
    """Without `lpips` the shim counts nothing and reports NaN; with it,
    `update` raises instead of counting a frame it gave no value."""
    m = LPIPSMeter()
    m.available = False
    m.update(np.zeros((4, 4, 3)), np.ones((4, 4, 3)))
    assert m.N == 0 and np.isnan(m.measure())
    m.available = True
    with pytest.raises(NotImplementedError):
        m.update(np.zeros((4, 4, 3)), np.ones((4, 4, 3)))
    assert m.N == 0 and np.isnan(m.measure())


def test_mesh_extraction_matches_the_jax_wrapper(tmp_path):
    """One shared 24^3 volume: vertices and faces equal, and the PLY files
    the same bytes."""
    g = np.linspace(-1, 1, 24, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    vol = (10.0 - 20.0 * (X**2 + 1.3 * Y**2 + 0.8 * Z**2) + 2.0 * np.sin(5 * X)).astype(
        np.float32)
    vj, fj = jax_marching_tetrahedra(vol, 0.5)
    vt, ft = marching_tetrahedra(vol, 0.5)
    assert len(fj) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    jax_save_ply(str(tmp_path / "j.ply"), vj, fj)
    save_ply(str(tmp_path / "t.ply"), vt, ft)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
