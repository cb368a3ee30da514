"""COCO-style 2D annotation export, devkit- and shapely-free (the port's
numpy copy of ``deepinteraction_tpu/data/anno_2d.py``).

Rebuild of the reference's ``export_2d_annotation`` + ``get_2d_boxes`` +
``post_process_coords`` + ``generate_record``
(tools/data_converter/nuscenes_converter.py:334-625): every camera keyframe
gets its 3D sample annotations re-projected to 2D boxes (convex hull of the
in-front corners intersected with the image canvas) plus, with ``mono3d``,
the camera-frame 3D box / velocity / projected center / attribute the
mono3d heads consume. Geometry that the reference delegates to
pyquaternion/shapely is inlined: monotone-chain convex hull and
Sutherland-Hodgman polygon clipping.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .nuscenes_converter import CAM_ORDER, NAME_MAPPING, Tables, _box_velocity, quat_to_rot

# reference nuscenes_converter.py:16-24
NUS_CATEGORIES = (
    "car", "truck", "trailer", "bus", "construction_vehicle",
    "bicycle", "motorcycle", "pedestrian", "traffic_cone", "barrier",
)
NUS_ATTRIBUTES = (
    "cycle.with_rider", "cycle.without_rider",
    "pedestrian.moving", "pedestrian.standing",
    "pedestrian.sitting_lying_down", "vehicle.moving",
    "vehicle.parked", "vehicle.stopped", "None",
)

# local box corners: x along length, y along width, z along height
# (devkit Box.corners axis convention)
_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
    np.float64,
)


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; pts [N,2] -> hull vertices CCW [M,2]."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out: List[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _clip_poly_rect(poly: np.ndarray, w: float, h: float) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon [N,2] to [0,w]x[0,h]."""
    def clip_edge(pts, inside, intersect):
        out: List[np.ndarray] = []
        n = len(pts)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            ia, ib = inside(a), inside(b)
            if ia:
                out.append(a)
                if not ib:
                    out.append(intersect(a, b))
            elif ib:
                out.append(intersect(a, b))
        return np.asarray(out) if out else np.zeros((0, 2))

    def x_cross(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cross(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return np.array([a[0] + t * (b[0] - a[0]), y])

    for inside, intersect in (
        (lambda p: p[0] >= 0, lambda a, b: x_cross(a, b, 0.0)),
        (lambda p: p[0] <= w, lambda a, b: x_cross(a, b, w)),
        (lambda p: p[1] >= 0, lambda a, b: y_cross(a, b, 0.0)),
        (lambda p: p[1] <= h, lambda a, b: y_cross(a, b, h)),
    ):
        if len(poly) == 0:
            return poly
        poly = clip_edge(poly, inside, intersect)
    return poly


def post_process_coords(
    corner_coords: np.ndarray, imsize: Tuple[float, float]
) -> Optional[Tuple[float, float, float, float]]:
    """bbox of (convex hull of projected corners) ∩ (image canvas); None if
    empty (reference post_process_coords, L531-562)."""
    hull = _convex_hull(np.asarray(corner_coords, np.float64))
    if len(hull) == 0:
        return None
    if len(hull) <= 2:  # degenerate: clip the points directly
        inside = (
            (hull[:, 0] >= 0) & (hull[:, 0] <= imsize[0])
            & (hull[:, 1] >= 0) & (hull[:, 1] <= imsize[1])
        )
        hull = hull[inside]
        if len(hull) == 0:
            return None
    else:
        hull = _clip_poly_rect(hull, float(imsize[0]), float(imsize[1]))
        if len(hull) == 0:
            return None
    return (
        float(hull[:, 0].min()), float(hull[:, 1].min()),
        float(hull[:, 0].max()), float(hull[:, 1].max()),
    )


def _yaw(r: np.ndarray) -> float:
    return float(np.arctan2(r[1, 0], r[0, 0]))


def get_2d_boxes(
    tables: Tables,
    cam_sd: dict,
    visibilities: Sequence[str],
    mono3d: bool = True,
) -> List[dict]:
    """2D (+mono3d) records for one camera keyframe (reference
    get_2d_boxes, L399-528)."""
    assert cam_sd["is_key_frame"], "2D re-projections are keyframe-only"
    cal = tables.calibrated_sensor[cam_sd["calibrated_sensor_token"]]
    k = np.asarray(cal["camera_intrinsic"], np.float64)
    r_ge, t_e, r_se, t_s = tables.pose(cam_sd)  # ego->global, cam->ego
    w_img = float(cam_sd.get("width", 1600))
    h_img = float(cam_sd.get("height", 900))

    recs: List[dict] = []
    for ann in tables.sample_to_anns.get(cam_sd["sample_token"], []):
        if str(ann.get("visibility_token", "")) not in visibilities:
            continue
        inst = tables.instance[ann["instance_token"]]
        cat_name = tables.category[inst["category_token"]]["name"]
        det_name = NAME_MAPPING.get(cat_name)
        if det_name is None:
            continue

        # box -> camera frame (global -> ego -> cam)
        w, l, h = np.asarray(ann["size"], np.float64)
        r_box = quat_to_rot(np.asarray(ann["rotation"], np.float64))
        corners_l = _CORNER_SIGNS * np.array([l / 2, w / 2, h / 2])
        ctr_g = np.asarray(ann["translation"], np.float64)
        corners_g = corners_l @ r_box.T + ctr_g
        # p_cam = R_cam_ego^T ((R_ego_glob^T (p - t_ego)) - t_cam), row-vec form
        to_cam = lambda p: ((p - t_e) @ r_ge - t_s) @ r_se  # noqa: E731
        corners_c = to_cam(corners_g)
        ctr_c = to_cam(ctr_g)

        in_front = corners_c[:, 2] > 0
        if not in_front.any():
            continue
        vis = corners_c[in_front]
        proj = vis @ k.T
        proj = proj[:, :2] / proj[:, 2:3]
        final = post_process_coords(proj, (w_img, h_img))
        if final is None:
            continue
        x1, y1, x2, y2 = final

        # generate_record (reference L585-625)
        rec = {
            "file_name": cam_sd["filename"],
            "image_id": cam_sd["token"],
            "area": (y2 - y1) * (x2 - x1),
            "category_name": det_name,
            "category_id": NUS_CATEGORIES.index(det_name),
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "iscrowd": 0,
            "bbox_corners": [x1, y1, x2, y2],
            "sample_annotation_token": ann["token"],
            "sample_data_token": cam_sd["token"],
            "visibility_token": str(ann.get("visibility_token", "")),
            "segmentation": [],
        }

        if mono3d:
            r_cam_box = r_se.T @ r_ge.T @ r_box
            # devkit wlh -> reference record order [l, h, w] (L490-492)
            dim = [float(l), float(h), float(w)]
            v_g = np.nan_to_num(_box_velocity(tables, ann))
            v_c = v_g @ r_ge @ r_se
            center3d = ctr_c @ k.T
            depth = float(center3d[2])
            if depth <= 0:
                continue
            toks = ann.get("attribute_tokens", ())
            attr_name = (
                tables.attribute[toks[0]]["name"] if toks else "None"
            )
            rec.update(
                bbox_cam3d=[*map(float, ctr_c)] + dim + [-_yaw(r_cam_box)],
                velo_cam3d=[float(v_c[0]), float(v_c[2])],
                center2d=[
                    float(center3d[0] / depth),
                    float(center3d[1] / depth),
                    depth,
                ],
                attribute_name=attr_name,
                attribute_id=NUS_ATTRIBUTES.index(attr_name)
                if attr_name in NUS_ATTRIBUTES
                else NUS_ATTRIBUTES.index("None"),
            )
        recs.append(rec)
    return recs


def export_2d_annotation(
    data_root: str,
    info_path: str,
    version: str,
    mono3d: bool = True,
    visibilities: Sequence[str] = ("", "1", "2", "3", "4"),
) -> str:
    """Write ``<info_path minus .pkl>[_mono3d].coco.json`` (reference
    export_2d_annotation, L334-396). Returns the output path."""
    tables = Tables(data_root, version)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)["infos"]

    coco = {
        "annotations": [],
        "images": [],
        "categories": [
            {"id": i, "name": n} for i, n in enumerate(NUS_CATEGORIES)
        ],
    }
    ann_id = 0
    for info in infos:
        sds = {
            tables.sensor_channel(sd): sd
            for sd in tables.sample_to_data[info["token"]]
            if sd["is_key_frame"]
        }
        for cam in CAM_ORDER:
            if cam not in sds:
                continue
            sd = sds[cam]
            cal = tables.calibrated_sensor[sd["calibrated_sensor_token"]]
            ego = tables.ego_pose[sd["ego_pose_token"]]
            coco["images"].append(
                {
                    "file_name": sd["filename"],
                    "id": sd["token"],
                    "token": info["token"],
                    "cam2ego_rotation": list(cal["rotation"]),
                    "cam2ego_translation": list(cal["translation"]),
                    "ego2global_rotation": list(ego["rotation"]),
                    "ego2global_translation": list(ego["translation"]),
                    "cam_intrinsic": np.asarray(
                        cal["camera_intrinsic"], np.float64
                    ).tolist(),
                    "width": int(sd.get("width", 1600)),
                    "height": int(sd.get("height", 900)),
                }
            )
            for rec in get_2d_boxes(tables, sd, visibilities, mono3d):
                rec["id"] = ann_id
                ann_id += 1
                coco["annotations"].append(rec)

    suffix = "_mono3d.coco.json" if mono3d else ".coco.json"
    out_path = info_path[: -len(".pkl")] + suffix
    with open(out_path, "w") as f:
        json.dump(coco, f)
    return out_path
