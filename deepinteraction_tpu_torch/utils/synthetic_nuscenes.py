"""Synthetic raw nuScenes trees (port of
``deepinteraction_tpu/utils/synthetic_nuscenes.py``), written without cv2
on the card: JSON tables, LiDAR sweeps as ``.bin`` and six cameras as
``.jpg``.

:func:`write_synthetic_nuscenes` is the tiny tree (one scene, 500-point
clouds, one random 32x24 image for every camera) of the tests and demos.
Its tables and clouds are the JAX writer's for the same seed; its JPEG is
encoded by ``ops/jpeg.py`` at quality 95 (cv2's default): on the CPU with
cv2, so the tree is the JAX writer's byte for byte, and on the card with
nvJPEG.

:func:`write_realistic_nuscenes` is the realistic-scale tree. Its tables,
clouds and boxes are the JAX writer's for the same seed (the same numpy
draws in the same order). The camera renders are made with tensors on
``device``: the background's upsampling is ``F.interpolate`` (bilinear)
where the JAX writer calls ``cv2.resize``, each box's convex hull (a numpy
monotone chain, ``cv2.convexHull`` there) is filled by half-plane tests on
the pixel grid (``cv2.fillConvexPoly`` there), and the JPEGs are encoded
by ``ops/jpeg.py`` (nvJPEG on the card, cv2 on the CPU), quality 95 with
4:2:0 chroma, cv2's defaults. So pixels can differ from the JAX writer's
at polygon edges and by the upsampling's rounding. The renders are made in
RGB; the JAX writer's colours are BGR, as cv2 writes them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.nuscenes_converter import CAM_ORDER, quat_to_rot
from ..ops import jpeg


def _rot_to_quat(rot: np.ndarray) -> list:
    """3x3 proper rotation -> (w, x, y, z) quaternion."""
    w = np.sqrt(max(0.0, 1 + rot[0, 0] + rot[1, 1] + rot[2, 2])) / 2
    if w > 1e-6:
        q = [
            w,
            (rot[2, 1] - rot[1, 2]) / (4 * w),
            (rot[0, 2] - rot[2, 0]) / (4 * w),
            (rot[1, 0] - rot[0, 1]) / (4 * w),
        ]
    else:
        d = np.diag(rot)
        k = int(np.argmax(d))
        x = np.sqrt(max(0.0, 1 + 2 * d[k] - d.sum())) / 2
        q3 = [0.0, 0.0, 0.0]
        q3[k] = x
        off = [(2, 1), (0, 2), (1, 0)]
        q = [0.0] + q3
        for j in range(3):
            if j != k:
                a, b = off[j]
                q[j + 1] = (rot[a, b] + rot[b, a]) / (4 * x) if x > 0 else 0.0
        q[0] = (rot[off[k][0], off[k][1]] - rot[off[k][1], off[k][0]]) / (4 * x)
    np.testing.assert_allclose(quat_to_rot(np.asarray(q)), rot, atol=1e-6)
    return [float(v) for v in q]


PTS_PER_CLOUD = 500


def _write_cloud(path: str, rng: np.random.Generator, n: int = PTS_PER_CLOUD):
    pts = rng.uniform(-6, 6, size=(n, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 2, size=n)
    pts[:, 4] = 0
    pts.tofile(path)


def write_synthetic_nuscenes(
    root: str,
    num_samples: int = 3,
    version: str = "v1.0-mini",
    scene_name: str = "scene-9001",
    seed: int = 0,
    image_hw: tuple = (24, 32),
    device="cuda",
) -> str:
    """A tiny raw nuScenes tree the converter accepts: a 6-camera rig,
    keyframe LiDAR plus one intermediate sweep, and two annotated instances
    per sample moving at 1 m/s along +x. The camera image is encoded on
    ``device``."""
    os.makedirs(f"{root}/{version}", exist_ok=True)
    rng = np.random.default_rng(seed)

    ident = [1.0, 0.0, 0.0, 0.0]
    sensors = [{"token": "sen_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}]
    cals = [
        {
            "token": "cal_lidar",
            "sensor_token": "sen_lidar",
            "rotation": ident,
            "translation": [0.0, 0.0, 1.8],
            "camera_intrinsic": [],
        }
    ]
    for i, cam in enumerate(CAM_ORDER):
        sensors.append({"token": f"sen_{cam}", "channel": cam, "modality": "camera"})
        ang = 2 * np.pi * i / 6
        # columns are the camera axes in the ego frame: x=(sin,-cos,0) right,
        # y=(0,0,-1) down, z=(cos,sin,0) forward (proper rotation, det=+1)
        rot = np.array(
            [
                [np.sin(ang), 0.0, np.cos(ang)],
                [-np.cos(ang), 0.0, np.sin(ang)],
                [0.0, -1.0, 0.0],
            ]
        )
        cals.append(
            {
                "token": f"cal_{cam}",
                "sensor_token": f"sen_{cam}",
                "rotation": _rot_to_quat(rot),
                "translation": [0.0, 0.0, 1.5],
                "camera_intrinsic": [
                    [20.0, 0.0, 16.0],
                    [0.0, 20.0, 12.0],
                    [0.0, 0.0, 1.0],
                ],
            }
        )

    samples, sample_datas, ego_poses, anns = [], [], [], []
    h, w = image_hw
    bgr = (rng.uniform(0, 255, size=(h, w, 3))).astype(np.uint8)  # the JAX writer's cv2 image
    img = jpeg.encode(torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1])).to(device), quality=95)
    for s in range(num_samples):
        stok = f"sample{s}"
        ts = 1_000_000 * (s + 1)
        samples.append(
            {
                "token": stok,
                "timestamp": ts,
                "scene_token": "scene0",
                "prev": f"sample{s-1}" if s > 0 else "",
                "next": f"sample{s+1}" if s < num_samples - 1 else "",
            }
        )
        ego_poses.append(
            {
                "token": f"ego{s}",
                "rotation": ident,
                "translation": [float(s), 0.0, 0.0],
                "timestamp": ts,
            }
        )
        lp = f"samples/LIDAR_TOP/pc{s}.bin"
        os.makedirs(os.path.dirname(f"{root}/{lp}"), exist_ok=True)
        _write_cloud(f"{root}/{lp}", rng)
        sample_datas.append(
            {
                "token": f"sd_lidar{s}",
                "sample_token": stok,
                "ego_pose_token": f"ego{s}",
                "calibrated_sensor_token": "cal_lidar",
                "filename": lp,
                "is_key_frame": True,
                "timestamp": ts,
                "prev": f"sd_sweep{s}" if s > 0 else "",
                "next": "",
            }
        )
        if s > 0:
            sp = f"sweeps/LIDAR_TOP/sw{s}.bin"
            os.makedirs(os.path.dirname(f"{root}/{sp}"), exist_ok=True)
            _write_cloud(f"{root}/{sp}", rng)
            sample_datas.append(
                {
                    "token": f"sd_sweep{s}",
                    "sample_token": stok,
                    "ego_pose_token": f"ego{s}",
                    "calibrated_sensor_token": "cal_lidar",
                    "filename": sp,
                    "is_key_frame": False,
                    "timestamp": ts - 50_000,
                    "prev": "",
                    "next": f"sd_lidar{s}",
                }
            )
        for cam in CAM_ORDER:
            ip = f"samples/{cam}/img{s}.jpg"
            os.makedirs(os.path.dirname(f"{root}/{ip}"), exist_ok=True)
            img.tofile(f"{root}/{ip}")
            sample_datas.append(
                {
                    "token": f"sd_{cam}{s}",
                    "sample_token": stok,
                    "ego_pose_token": f"ego{s}",
                    "calibrated_sensor_token": f"cal_{cam}",
                    "filename": ip,
                    "is_key_frame": True,
                    "timestamp": ts,
                    "prev": "",
                    "next": "",
                    # real nuScenes camera sample_datas carry these
                    "width": w,
                    "height": h,
                }
            )
        for a in range(2):
            anns.append(
                {
                    "token": f"ann{s}_{a}",
                    "sample_token": stok,
                    "instance_token": f"inst{a}",
                    "translation": [2.0 + s + a, 1.0 - a, 0.5],
                    "size": [1.8, 4.2, 1.6],  # (w, l, h)
                    "rotation": ident,
                    "prev": f"ann{s-1}_{a}" if s > 0 else "",
                    "next": f"ann{s+1}_{a}" if s < num_samples - 1 else "",
                    "num_lidar_pts": 10,
                    "num_radar_pts": 0,
                }
            )
    tables = {
        "sample": samples,
        "sample_data": sample_datas,
        "ego_pose": ego_poses,
        "calibrated_sensor": cals,
        "sensor": sensors,
        "sample_annotation": anns,
        "instance": [
            {"token": "inst0", "category_token": "cat_car"},
            {"token": "inst1", "category_token": "cat_ped"},
        ],
        "category": [
            {"token": "cat_car", "name": "vehicle.car"},
            {"token": "cat_ped", "name": "human.pedestrian.adult"},
        ],
        "scene": [
            {
                "token": "scene0",
                "name": scene_name,
                "first_sample_token": "sample0",
                "log_token": "log0",
            }
        ],
        "log": [{"token": "log0", "location": "synthetic"}],
    }
    for name, rows in tables.items():
        with open(f"{root}/{version}/{name}.json", "w") as f:
            json.dump(rows, f)
    return root


# (category name, mean (w, l, h), speed range m/s, BGR render color)
_REAL_CLASSES = [
    ("vehicle.car", (1.95, 4.62, 1.73), (0.0, 9.0), (60, 60, 230)),
    ("vehicle.truck", (2.51, 6.93, 2.84), (0.0, 7.0), (40, 140, 255)),
    ("vehicle.bus.rigid", (2.94, 11.0, 3.47), (0.0, 7.0), (0, 215, 255)),
    ("vehicle.trailer", (2.90, 12.29, 3.87), (0.0, 5.0), (140, 180, 210)),
    ("vehicle.construction", (2.85, 6.37, 3.19), (0.0, 2.0), (30, 105, 210)),
    ("human.pedestrian.adult", (0.67, 0.73, 1.77), (0.3, 1.5), (180, 130, 70)),
    ("vehicle.motorcycle", (0.77, 2.11, 1.47), (0.0, 8.0), (190, 80, 190)),
    ("vehicle.bicycle", (0.60, 1.70, 1.28), (0.5, 4.0), (80, 190, 80)),
    ("movable_object.trafficcone", (0.41, 0.41, 1.07), (0.0, 0.0), (0, 140, 255)),
    ("movable_object.barrier", (2.53, 0.50, 0.98), (0.0, 0.0), (150, 150, 150)),
]
# class mix roughly like nuScenes (cars dominate)
_REAL_CLASS_P = [0.38, 0.10, 0.04, 0.04, 0.04, 0.18, 0.05, 0.05, 0.06, 0.06]

_LIDAR_Z = 1.8  # lidar mount height (ego frame), matches the tiny rig


def _box_surface_points(rng, dims, n: int):
    """~n points on the 4 side + top faces of an axis-aligned box centered
    at the origin (local frame: x=length, y=width, z=height), with outward
    normals so callers can cull the faces hidden from the sensor."""
    w, l, h = dims
    areas = np.array([w * h, w * h, l * h, l * h, l * w], float)  # +x -x +y -y top
    cnt = np.maximum(1, (areas / areas.sum() * n).astype(int))
    pts, nrm = [], []
    for face, c in enumerate(cnt):
        u = rng.uniform(-0.5, 0.5, size=(c, 2))
        if face < 2:  # +-x faces (the box ends)
            s = 1.0 if face == 0 else -1.0
            pts.append(np.stack([np.full(c, s * l / 2), u[:, 0] * w, u[:, 1] * h], 1))
            nrm.append(np.tile([s, 0.0, 0.0], (c, 1)))
        elif face < 4:  # +-y faces (the box sides)
            s = 1.0 if face == 2 else -1.0
            pts.append(np.stack([u[:, 0] * l, np.full(c, s * w / 2), u[:, 1] * h], 1))
            nrm.append(np.tile([0.0, s, 0.0], (c, 1)))
        else:  # top
            pts.append(np.stack([u[:, 0] * l, u[:, 1] * w, np.full(c, h / 2)], 1))
            nrm.append(np.tile([0.0, 0.0, 1.0], (c, 1)))
    return np.concatenate(pts), np.concatenate(nrm)


def _lidar_cloud(rng, objs, ego_x: float, beams: int, az_steps: int):
    """One structured cloud in the LIDAR frame: ground rings + visible box
    surfaces + a few wall slabs. objs = list of dicts with global center/
    dims/yaw/cls/walls. Returns ([N, 5] f32, per-obj point counts)."""
    pts = []
    # ground rings: downward beams of a spinning lidar at z=+_LIDAR_Z
    elev = np.linspace(np.deg2rad(-30.7), np.deg2rad(-2.0), beams)
    az = np.linspace(0.0, 2 * np.pi, az_steps, endpoint=False)
    r = _LIDAR_Z / np.tan(-elev)  # [beams]
    rr, aa = np.meshgrid(r, az)
    keep = rr.ravel() <= 54.0
    rr = rr.ravel()[keep] * rng.normal(1.0, 0.005, size=keep.sum())
    aa = aa.ravel()[keep]
    ground = np.stack(
        [rr * np.cos(aa), rr * np.sin(aa), np.full_like(rr, -_LIDAR_Z)], 1
    )
    inten = rng.uniform(5, 15, size=(len(ground), 1))
    pts.append(np.concatenate([ground, inten, np.zeros_like(inten)], 1))

    counts = []
    for o in objs:
        ctr = np.asarray(o["ctr_g"], float) - np.array([ego_x, 0.0, _LIDAR_Z])
        dist = float(np.hypot(ctr[0], ctr[1]))
        if dist > 56.0:
            counts.append(0)
            continue
        w, l, h = o["dims"]
        n = int(np.clip(9000.0 * np.sqrt(w * l + h * h) / max(dist, 3.0) ** 1.5, 8, 2500))
        local, nrm = _box_surface_points(rng, o["dims"], n)
        cy, sy = np.cos(o["yaw"]), np.sin(o["yaw"])
        rot = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        p = local @ rot.T + ctr
        nr = nrm @ rot.T
        vis = np.einsum("ij,ij->i", nr, -p) > 0  # faces the sensor at origin
        if not vis.any():
            vis[:] = True
        p = p[vis] + rng.normal(0.0, 0.015, size=(vis.sum(), 3))
        inten = np.full((len(p), 1), o["inten"]) + rng.normal(0, 2, (len(p), 1))
        pts.append(np.concatenate([p, inten, np.zeros_like(inten)], 1))
        counts.append(len(p))
    for wall in objs[0]["walls"] if objs else []:
        c = 1200
        u = rng.uniform(0, 1, size=(c, 2))
        base = np.asarray(wall["base"], float) - np.array([ego_x, 0.0, _LIDAR_Z])
        p = (
            base
            + np.outer(u[:, 0], wall["along"])
            + np.outer(u[:, 1], [0.0, 0.0, wall["height"]])
        )
        keep = np.hypot(p[:, 0], p[:, 1]) <= 54.0
        p = p[keep]
        inten = rng.uniform(15, 35, size=(len(p), 1))
        pts.append(np.concatenate([p, inten, np.zeros_like(inten)], 1))
    cloud = np.concatenate(pts).astype(np.float32)
    return cloud, counts


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull [k, 2] of integer points [n, 2] (Andrew's monotone
    chain), counter-clockwise, no collinear points."""
    p = sorted(set(map(tuple, pts.tolist())))
    if len(p) <= 2:
        return np.asarray(p, np.int64).reshape(-1, 2)

    def half(seq):
        out = []
        for q in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(q)
        return out

    lower, upper = half(p), half(reversed(p))
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def _fill_convex(img: torch.Tensor, hull: np.ndarray, color) -> None:
    """Set the pixels of img [H, W, 3] inside or on the convex polygon
    ``hull`` (counter-clockwise, integer pixel coordinates) to ``color``."""
    h, w = img.shape[:2]
    if len(hull) < 3:
        return
    (x0, y0), (x1, y1) = np.maximum(hull.min(0), 0), np.minimum(hull.max(0), (w - 1, h - 1))
    if x0 > x1 or y0 > y1:
        return
    ys = torch.arange(int(y0), int(y1) + 1, device=img.device)[:, None]
    xs = torch.arange(int(x0), int(x1) + 1, device=img.device)[None, :]
    inside = torch.ones((len(ys), xs.shape[1]), dtype=torch.bool, device=img.device)
    for a, b in zip(hull, np.roll(hull, -1, 0)):
        inside &= (int(b[0] - a[0]) * (ys - int(a[1])) - int(b[1] - a[1]) * (xs - int(a[0]))) >= 0
    region = img[int(y0) : int(y1) + 1, int(x0) : int(x1) + 1]
    region[inside] = torch.tensor(color, dtype=torch.uint8, device=img.device)


def _render_cam(objs, ego_x, cam_rot, cam_t, K, hw, bg: torch.Tensor) -> torch.Tensor:
    """Render one camera view (RGB): the scene's background plus
    per-class-coloured convex hulls of the projected 3D boxes, far to near."""
    h, w = hw
    img = bg.clone()
    order = sorted(
        range(len(objs)),
        key=lambda i: -np.hypot(objs[i]["ctr_g"][0] - ego_x, objs[i]["ctr_g"][1]),
    )
    for i in order:
        o = objs[i]
        bw, bl, bh = o["dims"]
        cy, sy = np.cos(o["yaw"]), np.sin(o["yaw"])
        rot = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        corners = np.array(
            [
                [sx * bl / 2, sy_ * bw / 2, sz * bh / 2]
                for sx in (-1, 1)
                for sy_ in (-1, 1)
                for sz in (-1, 1)
            ]
        )
        ctr_e = np.asarray(o["ctr_g"], float) - np.array([ego_x, 0.0, 0.0])
        pe = corners @ rot.T + ctr_e  # ego frame
        pc = (pe - cam_t) @ cam_rot  # camera frame (cam_rot columns = axes)
        front = pc[:, 2] > 0.5
        if front.sum() < 3:
            continue
        uv = pc[front, :2] / pc[front, 2:3]
        px = (K[:2, :2] @ uv.T).T + K[:2, 2]
        if (px[:, 0] < -200).all() or (px[:, 0] > w + 200).all():
            continue
        shade = 0.7 + 0.3 * (sum(map(ord, o["inst"])) % 97) / 97.0  # stable
        color = tuple(int(c * shade) for c in o["color"])[::-1]  # BGR -> RGB
        _fill_convex(img, _convex_hull(px.astype(np.int32)), color)
    return img


def _background(small: np.ndarray, hw, device) -> torch.Tensor:
    """The scene's camera background (RGB uint8 [H, W, 3]) from the JAX
    writer's BGR texture ``small``: bilinear upsampling, then the sky."""
    h, w = hw
    x = torch.from_numpy(np.ascontiguousarray(small[:, :, ::-1])).to(device).permute(2, 0, 1)[None].float()
    bg = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    bg = bg.round().clamp(0, 255).to(torch.uint8).contiguous()
    bg[: h // 2] = (bg[: h // 2].float() * 0.6 + 90).to(torch.uint8)  # sky
    return bg


def write_realistic_nuscenes(
    root: str,
    num_scenes: int = 24,
    samples_per_scene: int = 3,
    num_objects: int = 40,
    num_val_scenes: int = 6,
    version: str = "v1.0-trainval",
    seed: int = 0,
    image_hw: tuple = (900, 1600),
    beams: int = 24,
    az_steps: int = 1080,
    sweep_bins: int = 3,
    device="cuda",
) -> str:
    """Realistic-scale synthetic nuScenes: structured
    ~45k-point clouds per lidar spin (ground rings + visible box surfaces +
    wall slabs; ~10-sweep aggregate ~300-450k points saturates the
    train voxel/pillar capacities), dozens of moving objects per scene in
    all 10 detection classes, full 6-cam rigs at 1600x900 with class-
    colored box renderings, and enough scenes/objects that the eval-
    deviation quality gates resolve small mAP deltas. Same table schema as
    :func:`write_synthetic_nuscenes`; writes ``val_scenes.txt`` for the
    converter's trainval split. The cameras are rendered and encoded on
    ``device``."""
    os.makedirs(f"{root}/{version}", exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = image_hw
    fx = 0.785 * w  # ~65 deg horizontal FOV, like the real CAM_FRONT
    K = np.array([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]])

    ident = [1.0, 0.0, 0.0, 0.0]
    sensors = [{"token": "sen_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}]
    cals = [
        {
            "token": "cal_lidar",
            "sensor_token": "sen_lidar",
            "rotation": ident,
            "translation": [0.0, 0.0, _LIDAR_Z],
            "camera_intrinsic": [],
        }
    ]
    cam_rots, cam_ts = {}, {}
    for i, cam in enumerate(CAM_ORDER):
        sensors.append({"token": f"sen_{cam}", "channel": cam, "modality": "camera"})
        ang = 2 * np.pi * i / 6
        rot = np.array(
            [
                [np.sin(ang), 0.0, np.cos(ang)],
                [-np.cos(ang), 0.0, np.sin(ang)],
                [0.0, -1.0, 0.0],
            ]
        )
        cam_rots[cam], cam_ts[cam] = rot, np.array([0.0, 0.0, 1.5])
        cals.append(
            {
                "token": f"cal_{cam}",
                "sensor_token": f"sen_{cam}",
                "rotation": _rot_to_quat(rot),
                "translation": [0.0, 0.0, 1.5],
                "camera_intrinsic": K.tolist(),
            }
        )

    cat_names = sorted({c[0] for c in _REAL_CLASSES})
    categories = [{"token": f"cat{i}", "name": n} for i, n in enumerate(cat_names)]
    cat_token = {n: f"cat{i}" for i, n in enumerate(cat_names)}

    samples, sample_datas, ego_poses, anns, instances, scenes = [], [], [], [], [], []
    scene_names = [f"scene-8{k:03d}" for k in range(num_scenes)]
    ego_speed = 3.0

    for k, sname in enumerate(scene_names):
        stok0 = f"s{k}_0"
        scenes.append(
            {
                "token": f"scene{k}",
                "name": sname,
                "first_sample_token": stok0,
                "log_token": "log0",
            }
        )
        # static per-scene world: objects + walls
        cls_ix = rng.choice(len(_REAL_CLASSES), size=num_objects, p=_REAL_CLASS_P)
        objs = []
        for j, ci in enumerate(cls_ix):
            cname, dims0, spd, color = _REAL_CLASSES[ci]
            dims = np.asarray(dims0) * rng.uniform(0.85, 1.15, 3)
            r_ = rng.uniform(4.0, 50.0)
            th = rng.uniform(0, 2 * np.pi)
            yaw = rng.uniform(0, 2 * np.pi)
            speed = rng.uniform(*spd)
            objs.append(
                {
                    "inst": f"i{k}_{j}",
                    "cls": cname,
                    "dims": dims,  # (w, l, h)
                    "pos0": np.array([r_ * np.cos(th), r_ * np.sin(th), dims[2] / 2]),
                    "yaw": yaw,
                    "vel": speed * np.array([np.cos(yaw), np.sin(yaw), 0.0]),
                    "inten": {0: 45.0}.get(ci, 20.0 + 3.0 * ci),
                    "color": color,
                }
            )
            instances.append({"token": f"i{k}_{j}", "category_token": cat_token[cname]})
        walls = []
        for _ in range(6):
            th = rng.uniform(0, 2 * np.pi)
            r_ = rng.uniform(12.0, 50.0)
            direction = rng.uniform(0, 2 * np.pi)
            walls.append(
                {
                    "base": [r_ * np.cos(th), r_ * np.sin(th), 0.0],
                    "along": (
                        rng.uniform(6.0, 20.0)
                        * np.array([np.cos(direction), np.sin(direction), 0.0])
                    ).tolist(),
                    "height": rng.uniform(3.0, 8.0),
                }
            )
        # per-camera background texture (static per scene)
        bgs = {}
        for cam in CAM_ORDER:
            small = rng.integers(70, 150, size=(h // 16, w // 16, 3), dtype=np.uint8)
            bgs[cam] = _background(small, (h, w), device)

        base_ts = 10_000_000_000 * (k + 1)
        for s in range(samples_per_scene):
            stok = f"s{k}_{s}"
            ts = base_ts + 1_000_000 * s
            t_sec = float(s)
            ego_x = ego_speed * t_sec
            samples.append(
                {
                    "token": stok,
                    "timestamp": ts,
                    "scene_token": f"scene{k}",
                    "prev": f"s{k}_{s-1}" if s > 0 else "",
                    "next": f"s{k}_{s+1}" if s < samples_per_scene - 1 else "",
                }
            )
            ego_poses.append(
                {
                    "token": f"ego{k}_{s}",
                    "rotation": ident,
                    "translation": [ego_x, 0.0, 0.0],
                    "timestamp": ts,
                }
            )
            # object states at t (global frame)
            snap = [
                {
                    **o,
                    "ctr_g": o["pos0"] + o["vel"] * t_sec,
                    "walls": walls,
                }
                for o in objs
            ]
            lp = f"samples/LIDAR_TOP/{sname}_pc{s}.bin"
            os.makedirs(os.path.dirname(f"{root}/{lp}"), exist_ok=True)
            cloud, counts = _lidar_cloud(rng, snap, ego_x, beams, az_steps)
            cloud.tofile(f"{root}/{lp}")
            # sweep bins: fresh spins at earlier instants, shared across
            # the chained sweep slots (motion-smeared aggregate, like the
            # real 10-sweep concat)
            sweep_paths = []
            for j in range(sweep_bins):
                dt = -0.1 * (j + 1)
                sp = f"sweeps/LIDAR_TOP/{sname}_s{s}_{j}.bin"
                os.makedirs(os.path.dirname(f"{root}/{sp}"), exist_ok=True)
                snap_j = [
                    {**o, "ctr_g": o["pos0"] + o["vel"] * (t_sec + dt), "walls": walls}
                    for o in objs
                ]
                cl, _ = _lidar_cloud(rng, snap_j, ego_x + ego_speed * dt, beams, az_steps)
                cl.tofile(f"{root}/{sp}")
                sweep_paths.append(sp)
            # chain 9 sweep sample_datas over the shared bins
            n_sweeps = 9
            prev_tok = f"sw{k}_{s}_0"
            sample_datas.append(
                {
                    "token": f"sd_lidar{k}_{s}",
                    "sample_token": stok,
                    "ego_pose_token": f"ego{k}_{s}",
                    "calibrated_sensor_token": "cal_lidar",
                    "filename": lp,
                    "is_key_frame": True,
                    "timestamp": ts,
                    "prev": prev_tok,
                    "next": "",
                }
            )
            for j in range(n_sweeps):
                dt = -0.1 * (j + 1)
                ego_poses.append(
                    {
                        "token": f"egosw{k}_{s}_{j}",
                        "rotation": ident,
                        "translation": [ego_x + ego_speed * dt, 0.0, 0.0],
                        "timestamp": ts + int(dt * 1e6),
                    }
                )
                sample_datas.append(
                    {
                        "token": f"sw{k}_{s}_{j}",
                        "sample_token": stok,
                        "ego_pose_token": f"egosw{k}_{s}_{j}",
                        "calibrated_sensor_token": "cal_lidar",
                        "filename": sweep_paths[j % sweep_bins],
                        "is_key_frame": False,
                        "timestamp": ts + int(dt * 1e6),
                        "prev": f"sw{k}_{s}_{j+1}" if j < n_sweeps - 1 else "",
                        "next": f"sw{k}_{s}_{j-1}" if j > 0 else f"sd_lidar{k}_{s}",
                    }
                )
            for cam in CAM_ORDER:
                ip = f"samples/{cam}/{sname}_img{s}.jpg"
                os.makedirs(os.path.dirname(f"{root}/{ip}"), exist_ok=True)
                img = _render_cam(snap, ego_x, cam_rots[cam], cam_ts[cam], K, (h, w), bgs[cam])
                jpeg.encode(img, quality=95).tofile(f"{root}/{ip}")
                sample_datas.append(
                    {
                        "token": f"sd_{cam}{k}_{s}",
                        "sample_token": stok,
                        "ego_pose_token": f"ego{k}_{s}",
                        "calibrated_sensor_token": f"cal_{cam}",
                        "filename": ip,
                        "is_key_frame": True,
                        "timestamp": ts,
                        "prev": "",
                        "next": "",
                        "width": w,
                        "height": h,
                    }
                )
            for j, o in enumerate(snap):
                yaw = objs[j]["yaw"]
                anns.append(
                    {
                        "token": f"a{k}_{s}_{j}",
                        "sample_token": stok,
                        "instance_token": o["inst"],
                        "translation": [float(v) for v in o["ctr_g"]],
                        "size": [float(v) for v in o["dims"]],
                        "rotation": [
                            float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))
                        ],
                        "prev": f"a{k}_{s-1}_{j}" if s > 0 else "",
                        "next": f"a{k}_{s+1}_{j}" if s < samples_per_scene - 1 else "",
                        "num_lidar_pts": int(counts[j]),
                        "num_radar_pts": 0,
                    }
                )

    tables = {
        "sample": samples,
        "sample_data": sample_datas,
        "ego_pose": ego_poses,
        "calibrated_sensor": cals,
        "sensor": sensors,
        "sample_annotation": anns,
        "instance": instances,
        "category": categories,
        "scene": scenes,
        "log": [{"token": "log0", "location": "synthetic-realistic"}],
    }
    for name, rows in tables.items():
        with open(f"{root}/{version}/{name}.json", "w") as f:
            json.dump(rows, f)
    with open(f"{root}/val_scenes.txt", "w") as f:
        f.write("\n".join(scene_names[-num_val_scenes:]) + "\n")
    return root
