"""Textured-image renderer: the port's copy of ``scripts/render_scene.py``.

Synthesizes 1024x768 images of a corridor scene with rich procedural
texture, plus ground-truth calib files in the CONTOUR format
(``calib/NNNN.txt``), so the full pipeline -- frontend -> retrieval -> sweep
-> reconstruction -> GT evaluation -- runs end to end on pixels at hundreds
of images, with no external assets. It takes ``CameraConfig`` from the
port's own ``config.py`` and imports neither ``jax`` nor ``torch``;
``tests/test_torch_host_copies.py`` checks that it writes the same bytes as
the original.

Scene: a Manhattan corridor (stepped back wall + floor + ceiling + scattered
"poster" quads at varying depth), so two-view geometry is never planar-
degenerate and every view has parallax structure. Rendering is exact
per-pixel ray casting against axis-aligned textured quads, vectorized in
numpy, optionally supersampled to keep the procedural textures band-limited
under minification.

    python -m sfm_tpu_torch.render_scene N OUT_DIR
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from sfm_tpu_torch.config import CameraConfig


# --------------------------------------------------------------- textures


def fractal_texture(rng, h, w, octaves=5, base_cells=6, amp_decay=0.55):
    """Band-limited multi-octave value noise in [0, 1], float32.

    Each octave is bilinear-upsampled coarse noise; frequencies double per
    octave. Bilinear interpolation (not nearest) keeps the spectrum bounded
    by the finest octave's cell size, which the caller chooses to match the
    on-image sampling rate (anti-aliasing by construction).
    """
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    cells = base_cells
    for _ in range(octaves):
        cy, cx = min(cells, h), min(cells, w)
        coarse = rng.random((cy + 1, cx + 1), dtype=np.float32)
        yy = np.linspace(0, cy, h, endpoint=False, dtype=np.float32)
        xx = np.linspace(0, cx, w, endpoint=False, dtype=np.float32)
        y0 = np.floor(yy).astype(np.int32)
        x0 = np.floor(xx).astype(np.int32)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        c00 = coarse[y0][:, x0]
        c01 = coarse[y0][:, x0 + 1]
        c10 = coarse[y0 + 1][:, x0]
        c11 = coarse[y0 + 1][:, x0 + 1]
        out += amp * ((1 - fy) * ((1 - fx) * c00 + fx * c01)
                      + fy * ((1 - fx) * c10 + fx * c11))
        total += amp
        amp *= amp_decay
        cells *= 2
    out /= total
    # Stretch to full contrast: texture must carry gradient energy for DoG /
    # FAST detectors at every scale.
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


# ------------------------------------------------------------------ quads


class Quad:
    """Axis-aligned textured rectangle.

    axis: the constant coordinate (0=x, 1=y, 2=z); value: its position.
    (a, b) are the two free axes in increasing-index order; bounds in scene
    units; tex sampled at px_per_unit texels per unit.
    """

    __slots__ = ("axis", "value", "a_axis", "b_axis", "a0", "a1", "b0", "b1",
                 "tex", "ppu")

    def __init__(self, axis, value, a0, a1, b0, b1, tex, ppu):
        self.axis = axis
        self.value = value
        free = [i for i in range(3) if i != axis]
        self.a_axis, self.b_axis = free
        self.a0, self.a1, self.b0, self.b1 = a0, a1, b0, b1
        self.tex = tex
        self.ppu = ppu


def _tex_for(rng, a_len, b_len, ppu, octaves=5, base_cells_per_unit=1.5):
    h = max(8, int(round(b_len * ppu)))
    w = max(8, int(round(a_len * ppu)))
    base = max(2, int(round(base_cells_per_unit * max(a_len, b_len))))
    return fractal_texture(rng, h, w, octaves=octaves, base_cells=base)


def build_corridor(rng, length):
    """Quad soup for a corridor of the given x-extent (plus margins)."""
    quads = []
    x_lo, x_hi = -4.0, length + 4.0
    # Stepped back wall: 1-unit slabs alternating between two depths, each
    # with its own texture (the steps guarantee non-planar structure in
    # every view; slab seams create occlusion edges like real scenes).
    x = x_lo
    while x < x_hi:
        w = 1.0
        z = 5.6 if (int(np.floor(x)) % 2 == 0) else 6.3
        z += 0.08 * rng.standard_normal()
        quads.append(Quad(2, z, x, x + w, -2.4, 2.4,
                          _tex_for(rng, w, 4.8, 220, octaves=6), 220))
        x += w
    # Floor and ceiling: lower-frequency texture (fewer octaves) because
    # grazing-angle minification would alias fine detail into noise.
    seg = 8.0
    x = x_lo
    while x < x_hi:
        quads.append(Quad(1, 2.4, x, x + seg, 0.2, 7.0,
                          _tex_for(rng, seg, 6.8, 80, octaves=4), 80))
        quads.append(Quad(1, -2.4, x, x + seg, 0.2, 7.0,
                          _tex_for(rng, seg, 6.8, 80, octaves=4), 80))
        x += seg
    # Posters: closer floating quads -> strong parallax against the wall.
    n_posters = int((x_hi - x_lo) * 0.9)
    for _ in range(n_posters):
        cx_ = rng.uniform(x_lo, x_hi)
        cy_ = rng.uniform(-1.7, 1.7)
        sa = rng.uniform(0.5, 1.0)
        sb = rng.uniform(0.4, 0.8)
        z = rng.uniform(4.4, 5.3)
        quads.append(Quad(2, z, cx_ - sa, cx_ + sa, cy_ - sb, cy_ + sb,
                          _tex_for(rng, 2 * sa, 2 * sb, 260, octaves=6), 260))
    return quads


# -------------------------------------------------------------- rendering


def render_view(quads, K, R, C, width, height, supersample=2):
    """Exact ray cast of the quad soup from camera (R, C); returns u8 gray.

    Convention: x_cam = R @ (X_world - C); pixel = K @ x_cam (z divide) —
    the same P = K [R | -R C] the GT calib files carry.
    """
    ss = supersample
    W, H = width * ss, height * ss
    Ks = K.copy().astype(np.float64)
    Ks[:2] *= ss
    # Pixel-center ray directions in camera frame, rotated to world.
    u = ((np.arange(W) + 0.5 - Ks[0, 2]) / Ks[0, 0]).astype(np.float32)
    v = ((np.arange(H) + 0.5 - Ks[1, 2]) / Ks[1, 1]).astype(np.float32)
    du, dv = np.meshgrid(u, v)
    dirs_c = np.stack([du, dv, np.ones_like(du)], -1).reshape(-1, 3)
    dirs_w = dirs_c @ R.astype(np.float32)  # R.T @ d for each row
    C = C.astype(np.float32)
    npix = dirs_w.shape[0]

    # Cull quads outside the camera's x-window: the corridor's visibility is
    # local (z-depth <= ~7.5, FoV ~45 deg -> |x - C_x| <= ~10 covers every
    # ray that can hit), and every quad's a-axis is x. Without this, a
    # 200-camera corridor pays ~230 quads/ray instead of ~25.
    quads = [q for q in quads if q.a1 >= C[0] - 10.5 and q.a0 <= C[0] + 10.5]

    t_best = np.full(npix, np.inf, np.float64)
    q_best = np.full(npix, -1, np.int32)
    for qi, q in enumerate(quads):
        d_ax = dirs_w[:, q.axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (q.value - C[q.axis]) / d_ax
        a = C[q.a_axis] + t * dirs_w[:, q.a_axis]
        b = C[q.b_axis] + t * dirs_w[:, q.b_axis]
        hit = ((t > 0.2) & (t < t_best)
               & (a >= q.a0) & (a < q.a1) & (b >= q.b0) & (b < q.b1))
        t_best[hit] = t[hit]
        q_best[hit] = qi
    img = np.full(npix, 0.5, np.float32)  # miss = flat mid-gray (featureless)
    for qi, q in enumerate(quads):
        sel = q_best == qi
        if not sel.any():
            continue
        t = t_best[sel]
        a = C[q.a_axis] + t * dirs_w[sel, q.a_axis] - q.a0
        b = C[q.b_axis] + t * dirs_w[sel, q.b_axis] - q.b0
        th, tw = q.tex.shape
        ax = np.clip(a * q.ppu, 0, tw - 1.001)
        bx = np.clip(b * q.ppu, 0, th - 1.001)
        x0 = ax.astype(np.int32)
        y0 = bx.astype(np.int32)
        fx = (ax - x0).astype(np.float32)
        fy = (bx - y0).astype(np.float32)
        tex = q.tex
        val = ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
               + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))
        img[sel] = val
    img = img.reshape(H, W)
    if ss > 1:  # area-average downsample back to target resolution
        img = img.reshape(height, ss, width, ss).mean((1, 3))
    return np.clip(img * 235.0 + 10.0, 0, 255).astype(np.uint8)


def corridor_poses(n_cams):
    """Same trajectory as scale_bench.make_scene_corridor (comparability)."""
    L = n_cams * 0.5
    xs = np.arange(n_cams) * (L / n_cams)
    yaw = 0.08 * np.sin(np.arange(n_cams) * 0.05)
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    Rs = np.zeros((n_cams, 3, 3))
    Rs[:, 0, 0] = cy_
    Rs[:, 0, 2] = -sy_
    Rs[:, 1, 1] = 1.0
    Rs[:, 2, 0] = sy_
    Rs[:, 2, 2] = cy_
    centers = np.stack([xs, 0.05 * np.sin(xs), np.zeros(n_cams)], 1)
    return Rs, centers


def write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def write_calib(path, K, R, C):
    """GT projection in the bunny CONTOUR format (io/calib.py reads it)."""
    t = -R @ C
    P = K @ np.concatenate([R, t[:, None]], 1)
    with open(path, "w") as f:
        f.write("CONTOUR\n")
        for row in P:
            f.write("%.10g %.10g %.10g %.10g\n" % tuple(row))


def render_dataset(out_dir, n_cams, seed=0, supersample=2, log=print):
    """Render a full pixel dataset: images/NNNN.pgm + calib/NNNN.txt.

    Idempotent: returns immediately if the marker file says this exact
    (n_cams, seed, supersample, renderer-version) dataset is already there.
    """
    out = Path(out_dir)
    marker = out / ".render_meta"
    key = f"v3 n={n_cams} seed={seed} ss={supersample}"
    if marker.exists() and marker.read_text().strip() == key:
        return out
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "calib").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cam = CameraConfig()
    K = cam.K().astype(np.float64)
    quads = build_corridor(rng, n_cams * 0.5)
    Rs, centers = corridor_poses(n_cams)
    import time

    t0 = time.time()
    for c in range(n_cams):
        img = render_view(quads, K, Rs[c], centers[c], cam.width, cam.height,
                          supersample=supersample)
        write_pgm(out / "images" / f"{c:04d}.pgm", img)
        write_calib(out / "calib" / f"{c:04d}.txt", K, Rs[c], centers[c])
        if c % 50 == 49:
            log(f"rendered {c + 1}/{n_cams} ({(time.time() - t0) / (c + 1):.2f}s/img)")
    marker.write_text(key)
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit("usage: python -m sfm_tpu_torch.render_scene N OUT_DIR")
    out = render_dataset(sys.argv[2], int(sys.argv[1]))
    print(f"dataset at {out}")
