"""Exporters: poses/points JSON, ASCII PLY, COLMAP text + binary + SQLite,
MeshLab PLY, Bundler, NVM.

Counterpart of ``sfm_tpu/io/export.py``: the same files, byte for byte, for
the same ``ReconstructionResult``. Host numpy; the one computed quantity,
the quaternion of each rotation, comes from the port's
:func:`sfm_tpu_torch.geometry.rotations.quaternion_from_matrix` in float32,
as the reference computes it.
"""
from __future__ import annotations

import json
import sqlite3
from pathlib import Path
from typing import Dict, Optional

import numpy as np

import torch

from sfm_tpu_torch.geometry.rotations import quaternion_from_matrix as _quat


def quaternion_from_matrix(R) -> np.ndarray:
    """(w, x, y, z) of a 3x3 rotation, computed in float32."""
    return _quat(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()


def save_reconstruction(result, out_dir) -> Dict[str, str]:
    """Write poses.json, points3D.json, reconstruction.ply (C17 layout)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    poses = {
        f"{int(i):04d}.ppm": {
            "R": result.rotations[k].tolist(),
            "t": result.translations[k].reshape(-1).tolist(),
        }
        for k, i in enumerate(result.image_ids)
    }
    (out / "poses.json").write_text(json.dumps(poses, indent=2))

    points = []
    for m in range(len(result.points3d)):
        track = {}
        for v in range(result.obs_img.shape[1]):
            img = int(result.obs_img[m, v])
            if img < 0:
                continue
            track[f"{img:04d}.ppm"] = [float(x) for x in result.obs_xy[m, v]]
        points.append(
            {
                "point": [float(x) for x in result.points3d[m]],
                "track": track,
            }
        )
    (out / "points3D.json").write_text(json.dumps(points, indent=2))

    save_ply(result.points3d, out / "reconstruction.ply")
    (out / "intrinsics.json").write_text(
        json.dumps({k: float(v) for k, v in zip(("fx", "fy", "cx", "cy"), result.intrinsics)})
    )
    (out / "stats.json").write_text(json.dumps(result.stats, indent=2))
    return {"reconstruction_dir": str(out)}


def save_ply(points: np.ndarray, path, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud (ref save_ply :751-767)."""
    points = np.asarray(points)
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 128, np.uint8)
    with Path(path).open("w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


class SfMExporter:
    """Export a saved or in-memory reconstruction to interchange formats.

    Mirrors the reference surface (export.py:8-197): construct from a
    reconstruction directory (reads the JSON artifacts back) or directly from
    a ReconstructionResult, then export_colmap / export_meshlab / export_all.
    """

    def __init__(self, recon_dir=None, result=None, image_size=(1024, 768)):
        self.image_size = image_size
        if result is not None:
            self._from_result(result)
        elif recon_dir is not None:
            self._from_dir(Path(recon_dir))
        else:
            raise ValueError("need recon_dir or result")

    def _from_result(self, r):
        self.image_ids = [int(i) for i in r.image_ids]
        self.rotations = {int(i): r.rotations[k] for k, i in enumerate(r.image_ids)}
        self.translations = {int(i): r.translations[k] for k, i in enumerate(r.image_ids)}
        self.intr = np.asarray(r.intrinsics, np.float64)
        self.points = np.asarray(r.points3d)
        # tracks: per point, list of (img, x, y); filter <2 obs (ref :31-39)
        self.tracks = []
        keep = []
        for m in range(len(self.points)):
            tr = [
                (int(r.obs_img[m, v]), float(r.obs_xy[m, v, 0]), float(r.obs_xy[m, v, 1]))
                for v in range(r.obs_img.shape[1])
                if int(r.obs_img[m, v]) >= 0
            ]
            if len(tr) >= 2:
                keep.append(m)
                self.tracks.append(tr)
        self.points = self.points[keep]

    def _from_dir(self, d: Path):
        poses = json.loads((d / "poses.json").read_text())
        pts = json.loads((d / "points3D.json").read_text())
        intr_file = d / "intrinsics.json"
        if intr_file.exists():
            v = json.loads(intr_file.read_text())
            self.intr = np.array([v["fx"], v["fy"], v["cx"], v["cy"]])
        else:
            self.intr = np.array([1228.0, 1228.0, 512.0, 384.0])
        self.image_ids = []
        self.rotations = {}
        self.translations = {}
        for name, p in poses.items():
            img = int("".join(c for c in name.split(".")[0] if c.isdigit()))
            self.image_ids.append(img)
            self.rotations[img] = np.asarray(p["R"], np.float64)
            self.translations[img] = np.asarray(p["t"], np.float64).reshape(-1)
        self.points = np.array([p["point"] for p in pts]) if pts else np.zeros((0, 3))
        self.tracks = []
        keep = []
        for m, p in enumerate(pts):
            tr = [
                (int("".join(c for c in name.split(".")[0] if c.isdigit())), xy[0], xy[1])
                for name, xy in p.get("track", {}).items()
            ]
            if len(tr) >= 2:  # ref filters short tracks (export.py:31-39)
                keep.append(m)
                self.tracks.append(tr)
        self.points = self.points[keep] if len(self.points) else self.points

    # ------------------------------------------------------------- COLMAP

    def _obs_maps(self):
        """Per-image observation lists + the (img, point) -> POINT2D_IDX map
        COLMAP's track entries must reference."""
        per_image: Dict[int, list] = {i: [] for i in self.image_ids}
        obs_idx: Dict[tuple, int] = {}
        for pid, tr in enumerate(self.tracks):
            for img, x, y in tr:
                if img in per_image:
                    obs_idx[(img, pid)] = len(per_image[img])
                    per_image[img].append((pid, x, y))
        return per_image, obs_idx

    def export_colmap(self, out_dir) -> None:
        """cameras.txt / images.txt / points3D.txt (ref export.py:50-121)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        w, h = self.image_size
        fx, fy, cx, cy = self.intr

        with (out / "cameras.txt").open("w") as f:
            f.write("# Camera list with one line of data per camera:\n")
            f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            f.write(f"# Number of cameras: 1\n")
            f.write(f"1 PINHOLE {w} {h} {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f}\n")

        per_image, obs_idx = self._obs_maps()

        with (out / "images.txt").open("w") as f:
            f.write("# Image list with two lines of data per image:\n")
            f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
            f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
            f.write(f"# Number of images: {len(self.image_ids)}\n")
            for k, img in enumerate(sorted(self.image_ids)):
                q = np.asarray(quaternion_from_matrix(self.rotations[img]))
                t = self.translations[img]
                f.write(
                    f"{k + 1} {q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f} "
                    f"{t[0]:.8f} {t[1]:.8f} {t[2]:.8f} 1 {img:04d}.ppm\n"
                )
                obs = " ".join(
                    f"{x:.3f} {y:.3f} {pid + 1}" for pid, x, y in per_image[img]
                )
                f.write(obs + "\n")

        with (out / "points3D.txt").open("w") as f:
            f.write("# 3D point list with one line of data per point:\n")
            f.write(
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            )
            f.write(f"# Number of points: {len(self.points)}\n")
            img_rank = {img: k + 1 for k, img in enumerate(sorted(self.image_ids))}
            for pid, (p, tr) in enumerate(zip(self.points, self.tracks)):
                track_str = " ".join(
                    f"{img_rank[img]} {obs_idx[(img, pid)]}"
                    for (img, _, _) in tr
                    if img in img_rank
                )
                f.write(
                    f"{pid + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 128 128 128 1.0 {track_str}\n"
                )

    def export_colmap_bin(self, out_dir) -> None:
        """cameras.bin / images.bin / points3D.bin — COLMAP's default binary
        model format (what the GUI and most downstream tools load first).
        Beyond reference parity: the reference only writes the text format.
        """
        import struct

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        w, h = self.image_size
        fx, fy, cx, cy = (float(v) for v in self.intr)

        with (out / "cameras.bin").open("wb") as f:
            f.write(struct.pack("<Q", 1))
            # camera_id, model_id (PINHOLE = 1), width, height, params
            f.write(struct.pack("<iiQQ", 1, 1, w, h))
            f.write(struct.pack("<dddd", fx, fy, cx, cy))

        per_image, obs_idx = self._obs_maps()
        with (out / "images.bin").open("wb") as f:
            f.write(struct.pack("<Q", len(self.image_ids)))
            for k, img in enumerate(sorted(self.image_ids)):
                q = np.asarray(quaternion_from_matrix(self.rotations[img]), np.float64)
                t = np.asarray(self.translations[img], np.float64)
                f.write(struct.pack("<i", k + 1))
                f.write(struct.pack("<dddd", *q))
                f.write(struct.pack("<ddd", *t))
                f.write(struct.pack("<i", 1))
                f.write(f"{img:04d}.ppm".encode() + b"\x00")
                obs = per_image[img]
                f.write(struct.pack("<Q", len(obs)))
                for pid, x, y in obs:
                    f.write(struct.pack("<ddq", float(x), float(y), pid + 1))

        img_rank = {img: k + 1 for k, img in enumerate(sorted(self.image_ids))}
        with (out / "points3D.bin").open("wb") as f:
            f.write(struct.pack("<Q", len(self.points)))
            for pid, (p, tr) in enumerate(zip(self.points, self.tracks)):
                f.write(struct.pack("<q", pid + 1))
                f.write(struct.pack("<ddd", float(p[0]), float(p[1]), float(p[2])))
                f.write(struct.pack("<BBB", 128, 128, 128))
                f.write(struct.pack("<d", 1.0))
                track = [(img_rank[img], obs_idx[(img, pid)])
                         for (img, _, _) in tr if img in img_rank]
                f.write(struct.pack("<Q", len(track)))
                for image_id, p2d in track:
                    f.write(struct.pack("<ii", image_id, p2d))

    def create_colmap_database(self, path) -> None:
        """Minimal COLMAP SQLite db: cameras + images (ref export.py:153-183)."""
        db = sqlite3.connect(str(path))
        cur = db.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS cameras (camera_id INTEGER PRIMARY KEY, "
            "model INTEGER, width INTEGER, height INTEGER, params BLOB, "
            "prior_focal_length INTEGER)"
        )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS images (image_id INTEGER PRIMARY KEY, "
            "name TEXT, camera_id INTEGER)"
        )
        w, h = self.image_size
        params = np.asarray(self.intr, np.float64).tobytes()
        cur.execute(
            "INSERT OR REPLACE INTO cameras VALUES (1, 1, ?, ?, ?, 0)", (w, h, params)
        )
        for k, img in enumerate(sorted(self.image_ids)):
            cur.execute(
                "INSERT OR REPLACE INTO images VALUES (?, ?, 1)",
                (k + 1, f"{img:04d}.ppm"),
            )
        db.commit()
        db.close()

    def export_meshlab(self, path) -> None:
        """PLY for MeshLab — the method the reference advertises but never
        implemented (main.py:249 -> AttributeError; C20). Ours works."""
        save_ply(self.points, path)

    # -------------------------------------------- Bundler / VisualSFM (NVM)

    def export_bundler(self, path, list_path=None) -> None:
        """Bundler v0.3 `bundle.out` (+ optional image `list.txt`).

        Beyond reference parity: the interchange format consumed by PMVS/
        CMVS, Bundler-era MVS tools, and many academic pipelines. Axis
        convention differs from ours (OpenCV-like: z forward, y down):
        Bundler cameras look down -z with y up, so R/t are premultiplied by
        diag(1,-1,-1), and view-list pixel coords are relative to the image
        center with y up. Single focal = mean(fx, fy); k1 = k2 = 0 (our
        camera model is a pure pinhole).
        """
        D = np.diag([1.0, -1.0, -1.0])
        fx, fy, cx, cy = (float(v) for v in self.intr)
        f = 0.5 * (fx + fy)
        order = sorted(self.image_ids)
        cam_rank = {img: k for k, img in enumerate(order)}
        _, obs_idx = self._obs_maps()

        with Path(path).open("w") as out:
            out.write("# Bundle file v0.3\n")
            out.write(f"{len(order)} {len(self.points)}\n")
            for img in order:
                Rb = D @ np.asarray(self.rotations[img], np.float64)
                tb = D @ np.asarray(self.translations[img], np.float64).reshape(3)
                out.write(f"{f:.8g} 0 0\n")
                for row in Rb:
                    out.write(f"{row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
                out.write(f"{tb[0]:.9g} {tb[1]:.9g} {tb[2]:.9g}\n")
            for pid, (p, tr) in enumerate(zip(self.points, self.tracks)):
                out.write(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
                out.write("128 128 128\n")
                views = [
                    f"{cam_rank[img]} {obs_idx[(img, pid)]} "
                    f"{x - cx:.4f} {cy - y:.4f}"
                    for (img, x, y) in tr
                    if img in cam_rank
                ]
                out.write(f"{len(views)} " + " ".join(views) + "\n")
        if list_path is not None:
            Path(list_path).write_text(
                "".join(f"{img:04d}.ppm\n" for img in order)
            )

    def export_nvm(self, path) -> None:
        """VisualSFM NVM_V3 model.

        Beyond reference parity: loadable by VisualSFM, OpenMVS
        (InterfaceVisualSFM), and Theia. Per-camera line is
        `name focal qw qx qy qz Cx Cy Cz r 0` with C = -R^T t the camera
        CENTER (not our translation) and r the radial coefficient (0:
        pinhole). Measurements are pixel coords relative to the image
        center (NVM convention), y down like ours.
        """
        fx, fy, cx, cy = (float(v) for v in self.intr)
        f = 0.5 * (fx + fy)
        order = sorted(self.image_ids)
        cam_rank = {img: k for k, img in enumerate(order)}

        with Path(path).open("w") as out:
            out.write("NVM_V3\n\n")
            out.write(f"{len(order)}\n")
            for img in order:
                R = np.asarray(self.rotations[img], np.float64)
                t = np.asarray(self.translations[img], np.float64).reshape(3)
                q = np.asarray(quaternion_from_matrix(R), np.float64)
                C = -R.T @ t
                out.write(
                    f"{img:04d}.ppm {f:.8g} "
                    f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                    f"{C[0]:.9g} {C[1]:.9g} {C[2]:.9g} 0 0\n"
                )
            out.write(f"\n{len(self.points)}\n")
            _, obs_idx = self._obs_maps()
            for pid, (p, tr) in enumerate(zip(self.points, self.tracks)):
                views = [
                    f"{cam_rank[img]} {obs_idx[(img, pid)]} "
                    f"{x - cx:.4f} {y - cy:.4f}"
                    for (img, x, y) in tr
                    if img in cam_rank
                ]
                out.write(
                    f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 128 128 128 "
                    f"{len(views)} " + " ".join(views) + "\n"
                )

    def export_all(self, out_dir) -> None:
        """COLMAP text + binary + db + meshlab PLY + Bundler + NVM (ref
        export.py:185-197; binary model, Bundler, and NVM are beyond
        reference parity)."""
        out = Path(out_dir)
        colmap = out / "colmap"
        self.export_colmap(colmap)
        self.export_colmap_bin(colmap)
        self.create_colmap_database(colmap / "database.db")
        self.export_meshlab(out / "meshlab.ply")
        bundler = out / "bundler"
        bundler.mkdir(parents=True, exist_ok=True)
        self.export_bundler(bundler / "bundle.out", bundler / "list.txt")
        self.export_nvm(out / "model.nvm")
