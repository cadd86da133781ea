"""The port's COLMAP writers (``consistent_depth_tpu_torch/io/colmap_io.py``)
against the JAX package's: from one seeded model, the ``.bin``, ``.txt``
and dense-array files are byte-identical, each package reads what the
other wrote to an equal model, and ``save_colmap`` writes the same tree.
The conversions ``extrinsics_to_images``, ``intrinsics_to_camera`` and
``convert_points3D`` agree exactly (both are the same f64 numpy)."""

import os

import numpy as np
import pytest

from consistent_depth_tpu.io import colmap_io as jax_colmap
from consistent_depth_tpu_torch.io import colmap_io


def _model(mod, seed=0):
    """Cameras of four models, five images (one without points, ids with
    -1 for unmatched keypoints, names out of id order), and points with
    tracks of 0-3 observations, all from ``seed``."""
    rng = np.random.default_rng(seed)
    cameras = {}
    for cid, (model, n) in enumerate([("SIMPLE_PINHOLE", 3), ("PINHOLE", 4),
                                      ("SIMPLE_RADIAL", 4), ("OPENCV", 8)],
                                     start=1):
        cameras[cid] = mod.Camera(cid, model, int(rng.integers(32, 2000)),
                                  int(rng.integers(32, 2000)),
                                  rng.uniform(-1, 500, n))
    images = {}
    for iid in (3, 1, 5, 2, 4):
        n = 0 if iid == 4 else int(rng.integers(1, 9))
        q = rng.standard_normal(4)
        ids = rng.integers(1, 12, n)
        ids[rng.random(n) < 0.3] = -1
        images[iid] = mod.Image(
            id=iid, qvec=q / np.linalg.norm(q), tvec=rng.standard_normal(3),
            camera_id=int(rng.integers(1, 5)), name=f"frame_{9 - iid:06d}.png",
            xys=rng.uniform(0, 640, (n, 2)), point3D_ids=ids.astype(np.int64))
    points = {}
    for pid in range(1, 12):
        k = int(rng.integers(0, 4))
        points[pid] = mod.Point3D(
            id=pid, xyz=rng.standard_normal(3) * 10,
            rgb=rng.integers(0, 256, 3).astype(np.uint8),
            error=float(rng.random()),
            image_ids=rng.integers(1, 6, k).astype(np.int32),
            point2D_idxs=rng.integers(0, 8, k).astype(np.int32))
    return cameras, images, points


def _files(path):
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def _assert_same_model(a, b):
    """Two (cameras, images, points3D) triples, field by field (numpy
    arrays exactly, dtypes aside)."""
    assert len(a) == len(b) == 3
    for da, db in zip(a, b):
        assert list(da) == list(db)
        for k in da:
            va, vb = vars(da[k]), vars(db[k])
            assert va.keys() == vb.keys()
            for f in va:
                if isinstance(va[f], np.ndarray) or isinstance(
                        vb[f], np.ndarray):
                    np.testing.assert_array_equal(np.asarray(va[f]),
                                                  np.asarray(vb[f]),
                                                  err_msg=f"{k}.{f}")
                else:
                    assert va[f] == vb[f], (k, f)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_write_model_byte_identical(tmp_path, ext):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    colmap_io.write_model(*_model(colmap_io), str(port_dir), ext=ext)
    jax_colmap.write_model(*_model(jax_colmap), str(jax_dir), ext=ext)
    got, want = _files(port_dir), _files(jax_dir)
    assert sorted(got) == sorted(
        f"{n}{ext}" for n in ("cameras", "images", "points3D"))
    assert got == want


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_models_cross_both_ways(tmp_path, ext):
    """The port reads what JAX wrote, JAX reads what the port wrote, and
    both give the model that was written."""
    model = _model(colmap_io)
    colmap_io.write_model(*model, str(tmp_path / "port"), ext=ext)
    jax_colmap.write_model(*_model(jax_colmap), str(tmp_path / "jax"),
                           ext=ext)
    from_jax = colmap_io.read_model(str(tmp_path / "jax"), ext=ext)
    from_port = jax_colmap.read_model(str(tmp_path / "port"), ext=ext)
    _assert_same_model(from_jax, from_port)
    _assert_same_model(from_jax, model)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3)])
def test_write_array_byte_identical(tmp_path, shape):
    a = np.random.default_rng(1).standard_normal(shape)
    a[0, 0] = np.nan
    colmap_io.write_array(a, str(tmp_path / "port.bin"))
    jax_colmap.write_array(a, str(tmp_path / "jax.bin"))
    with open(tmp_path / "port.bin", "rb") as f, \
            open(tmp_path / "jax.bin", "rb") as g:
        assert f.read() == g.read()
    for read in (colmap_io.read_array, jax_colmap.read_array):
        np.testing.assert_array_equal(read(str(tmp_path / "port.bin")),
                                      a.astype(np.float32))


def _calibration(n=4, seed=2):
    rng = np.random.default_rng(seed)
    extr = []
    for _ in range(n):
        q = rng.standard_normal(4)
        R = jax_colmap.qvec2rotmat(q / np.linalg.norm(q))
        extr.append(np.concatenate([R, rng.standard_normal((3, 1))], 1))
    intr = np.tile([300.0, 300.004, 159.5, 119.5], (n, 1))
    return np.stack(extr), intr


@pytest.mark.parametrize("ext", [".txt", ".bin"])
@pytest.mark.parametrize("sizes", [(None, None), ((320, 240), (640, 480))])
def test_save_colmap_same_tree(tmp_path, ext, sizes):
    extr, intr = _calibration()
    if sizes[0] is not None:
        intr = intr * [1, 1.1, 1, 1]  # fx != fy: a PINHOLE camera
    colmap_io.save_colmap(str(tmp_path / "port"), intr, extr, *sizes, ext=ext)
    jax_colmap.save_colmap(str(tmp_path / "jax"), intr, extr, *sizes, ext=ext)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    cams, ims, pts = colmap_io.read_model(str(tmp_path / "port"), ext=ext)
    assert pts == {} and len(ims) == len(extr)
    # the round trip returns the extrinsics
    back = colmap_io.images_to_extrinsics(ims,
                                          colmap_io.ordered_image_ids(ims))
    np.testing.assert_allclose(back, extr, atol=1e-12)


def test_conversions_match_jax():
    extr, intr = _calibration()
    got = colmap_io.extrinsics_to_images(extr)
    want = jax_colmap.extrinsics_to_images(extr)
    _assert_same_model((got, {}, {}), (want, {}, {}))
    for args in [(), ((320, 240), (160, 120))]:
        for eps in (0.01, 1e-4):
            got = colmap_io.intrinsics_to_camera(intr, *args, eps=eps)
            want = jax_colmap.intrinsics_to_camera(intr, *args, eps=eps)
            _assert_same_model((got, {}, {}), (want, {}, {}))
    pts = np.random.default_rng(3).standard_normal((3, 10))
    np.testing.assert_array_equal(colmap_io.convert_points3D(pts),
                                  jax_colmap.convert_points3D(pts))
