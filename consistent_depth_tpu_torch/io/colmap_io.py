"""COLMAP model IO and the calibration conversion: the port's copy of
``consistent_depth_tpu/io/colmap_io.py`` (plain numpy, no dependency on the
COLMAP checkout).

Reads and writes the standard COLMAP sparse-model formats (cameras, images,
points3D in ``.bin``/``.txt``) and the dense patch-match array format
(``.geometric.bin``/``.photometric.bin``), byte for byte as the JAX
package writes them, and converts the calibration between COLMAP's
convention (y down, z forward) and this framework's (y up, camera looks
along -z).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Camera models (public COLMAP enumeration)
# ---------------------------------------------------------------------------

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) scalar-first quaternion
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Scalar-first unit quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> scalar-first quaternion (w >= 0)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


# ---------------------------------------------------------------------------
# Binary sparse model
# ---------------------------------------------------------------------------

def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * num_pts), dtype=[("xy", "<f8", 2), ("id", "<i8")]
            )
            images[image_id] = Image(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"),
                xys=np.array(data["xy"]).reshape(-1, 2),
                point3D_ids=np.array(data["id"]),
            )
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack(
                "<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            for k in range(n):
                f.write(struct.pack(
                    "<ddq", im.xys[k, 0], im.xys[k, 1], im.point3D_ids[k]))


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], dtype=np.uint8)
            error = vals[7]
            (track_len,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(8 * track_len), dtype=[("im", "<i4"), ("pt", "<i4")]
            )
            points[pid] = Point3D(
                id=pid, xyz=xyz, rgb=rgb, error=error,
                image_ids=np.array(data["im"]),
                point2D_idxs=np.array(data["pt"]),
            )
    return points


def write_points3d_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack(
                "<QdddBBBd", p.id, *p.xyz, *[int(v) for v in p.rgb], p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for im_id, pt_idx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(im_id), int(pt_idx)))


# ---------------------------------------------------------------------------
# Text sparse model
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = Camera(
                cam_id, elems[1], int(elems[2]), int(elems[3]),
                np.array([float(e) for e in elems[4:]]),
            )
    return cameras


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "r") as f:
        # keep empty lines: an image with no 2D points has an empty
        # points line that must stay paired with its meta line
        lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    if lines and not lines[-1].strip() and len(lines) % 2 == 1:
        lines = lines[:-1]
    for meta_line, pts_line in zip(lines[0::2], lines[1::2]):
        elems = meta_line.split()
        image_id = int(elems[0])
        qvec = np.array([float(e) for e in elems[1:5]])
        tvec = np.array([float(e) for e in elems[5:8]])
        camera_id = int(elems[8])
        name = elems[9]
        pts = pts_line.split()
        xys = np.array([float(v) for v in pts], dtype=np.float64)
        xys = xys.reshape(-1, 3) if len(pts) else np.zeros((0, 3))
        images[image_id] = Image(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name,
            xys=xys[:, :2], point3D_ids=xys[:, 2].astype(np.int64),
        )
    return images


def write_images_text(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                "CAMERA_ID, NAME then POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{float(x)!r} {float(y)!r} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(pts + "\n")


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array([float(e) for e in elems[1:4]])
            rgb = np.array([int(e) for e in elems[4:7]], dtype=np.uint8)
            error = float(elems[7])
            track = np.array([int(e) for e in elems[8:]], dtype=np.int64)
            track = track.reshape(-1, 2) if track.size else np.zeros((0, 2), np.int64)
            points[pid] = Point3D(
                id=pid, xyz=xyz, rgb=rgb, error=error,
                image_ids=track[:, 0], point2D_idxs=track[:, 1],
            )
    return points


def write_points3d_text(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}"
                for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {float(p.error)!r} {track}\n")


# ---------------------------------------------------------------------------
# Model directory read/write
# ---------------------------------------------------------------------------

def read_model(path: str, ext: str = ".bin"):
    """Returns (cameras, images, points3D) dicts."""
    j = os.path.join
    if ext == ".bin":
        cameras = read_cameras_binary(j(path, "cameras.bin"))
        images = read_images_binary(j(path, "images.bin"))
        p3d_path = j(path, "points3D.bin")
        points = read_points3d_binary(p3d_path) if os.path.isfile(p3d_path) else {}
    else:
        cameras = read_cameras_text(j(path, "cameras.txt"))
        images = read_images_text(j(path, "images.txt"))
        p3d_path = j(path, "points3D.txt")
        points = read_points3d_text(p3d_path) if os.path.isfile(p3d_path) else {}
    return cameras, images, points


def write_model(cameras, images, points3D, path: str, ext: str = ".bin"):
    j = os.path.join
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, j(path, "cameras.bin"))
        write_images_binary(images, j(path, "images.bin"))
        write_points3d_binary(points3D, j(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, j(path, "cameras.txt"))
        write_images_text(images, j(path, "images.txt"))
        write_points3d_text(points3D, j(path, "points3D.txt"))


# ---------------------------------------------------------------------------
# Dense array format (patch_match_stereo output)
# ---------------------------------------------------------------------------

def read_array(path: str) -> np.ndarray:
    """Read a COLMAP dense array (``*.geometric.bin``): ASCII header
    ``width&height&channels&`` followed by column-major float32 data."""
    with open(path, "rb") as f:
        header = b""
        delims = 0
        while delims < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"Truncated COLMAP array header in {path}")
            header += c
            if c == b"&":
                delims += 1
        width, height, channels = (int(v) for v in header.split(b"&")[:3])
        data = np.fromfile(f, np.float32)
    array = data.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


def write_array(array: np.ndarray, path: str) -> None:
    arr = np.asarray(array, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode("ascii"))
        np.transpose(arr, (1, 0, 2)).ravel(order="F").tofile(f)


# ---------------------------------------------------------------------------
# Calibration conversion (COLMAP <-> framework convention)
# ---------------------------------------------------------------------------

# COLMAP: y down, z forward. Framework: y up, camera looks along -z.
ROT_COLMAP_TO_NORMAL = np.diag([1.0, -1.0, -1.0])


def cameras_to_intrinsics(
    cameras: Dict[int, Camera], camera_ids: Sequence[int],
    size_new: Tuple[int, int],
) -> np.ndarray:
    """(fx, fy, cx, cy) rows rescaled to ``size_new`` = (W, H)
    (reference: utils/load_colmap.py:106-136)."""
    intrinsics = []
    for cid in camera_ids:
        c = cameras[cid]
        if c.model == "SIMPLE_PINHOLE":
            f, cx, cy = c.params
            fxy = np.array([f, f])
        elif c.model == "PINHOLE":
            fx, fy, cx, cy = c.params
            fxy = np.array([fx, fy])
        elif c.model == "SIMPLE_RADIAL":
            f, cx, cy, _r = c.params
            fxy = np.array([f, f])
        else:
            raise ValueError(f"Unsupported camera model {c.model}")
        ratio = np.array(size_new) / np.array((c.width, c.height))
        intrinsics.append(np.concatenate((fxy * ratio, np.array([cx, cy]) * ratio)))
    return np.stack(intrinsics, axis=0)


def images_to_extrinsics(
    images: Dict[int, Image], image_ids: Sequence[int]
) -> np.ndarray:
    """World-from-camera [R|t] rows (x_world = R p_cam + t) in the
    framework's y-up/-z-forward basis (reference: utils/load_colmap.py:139-158)."""
    extrinsics = []
    for iid in image_ids:
        im = images[iid]
        Rc, tc = qvec2rotmat(im.qvec), im.tvec
        R = Rc.T
        t = -Rc.T.dot(tc.reshape(-1, 1))
        R = ROT_COLMAP_TO_NORMAL.dot(R).dot(ROT_COLMAP_TO_NORMAL.T)
        t = ROT_COLMAP_TO_NORMAL.dot(t)
        extrinsics.append(np.concatenate([R, t], axis=1))
    return np.stack(extrinsics, axis=0)


def extrinsics_to_images(extrinsics: np.ndarray) -> Dict[int, Image]:
    """Inverse of :func:`images_to_extrinsics`
    (reference: utils/load_colmap.py:70-84)."""
    images = {}
    for i, extr in enumerate(extrinsics):
        R, t = extr[:, :3], extr[:, -1:]
        Rc = ROT_COLMAP_TO_NORMAL.dot(R.T).dot(ROT_COLMAP_TO_NORMAL.T)
        tc = -Rc.dot(ROT_COLMAP_TO_NORMAL.T).dot(t)
        images[i + 1] = Image(
            id=i + 1, qvec=rotmat2qvec(Rc), tvec=tc.flatten(), camera_id=1,
            name="frame_%06d.png" % i,
        )
    return images


def intrinsics_to_camera(
    intrinsics: np.ndarray,
    src_im_size: Optional[np.ndarray] = None,
    dst_im_size: Optional[np.ndarray] = None,
    eps: float = 0.01,
) -> Dict[int, Camera]:
    """Shared SIMPLE_PINHOLE/PINHOLE camera from an intrinsics row
    (reference: utils/load_colmap.py:34-67)."""
    fxy = np.array(intrinsics[0][:2], dtype=np.float64)
    cxy = np.array(intrinsics[0][-2:], dtype=np.float64)
    if src_im_size is None:
        src_im_size = (2 * cxy).astype(int)
    if dst_im_size is None:
        dst_im_size = src_im_size
    ratio = np.array(dst_im_size) / np.array(src_im_size, dtype=float)
    fxy = fxy * ratio
    cxy = cxy * ratio
    if abs(fxy[0] - fxy[1]) < eps:
        model, params = "SIMPLE_PINHOLE", np.array((fxy[0], cxy[0], cxy[1]))
    else:
        model, params = "PINHOLE", np.array((fxy[0], fxy[1], cxy[0], cxy[1]))
    cam = Camera(
        id=1, model=model,
        width=int(dst_im_size[0]), height=int(dst_im_size[1]), params=params,
    )
    return {cam.id: cam}


def ordered_image_ids(images: Dict[int, Image]) -> List[int]:
    return sorted(images.keys(), key=lambda iid: images[iid].name)


def convert_calibration(cameras, images, size_new):
    """COLMAP model -> (intrinsics (N,4), extrinsics (N,3,4)) sorted by
    image name (reference: utils/load_colmap.py:172-177)."""
    im_ids = ordered_image_ids(images)
    cam_ids = [images[iid].camera_id for iid in im_ids]
    return (
        cameras_to_intrinsics(cameras, cam_ids, size_new),
        images_to_extrinsics(images, im_ids),
    )


def convert_points3D(pts3D: np.ndarray) -> np.ndarray:
    """(3, N) points from COLMAP basis to framework basis."""
    return ROT_COLMAP_TO_NORMAL.dot(pts3D)


def save_colmap(path, intrinsics, extrinsics,
                src_im_size=None, dst_im_size=None, ext=".txt"):
    """Export intrinsics/extrinsics as an empty COLMAP project."""
    cameras = intrinsics_to_camera(
        intrinsics, src_im_size=src_im_size, dst_im_size=dst_im_size)
    images = extrinsics_to_images(extrinsics)
    write_model(cameras, images, {}, path, ext)
