"""MMRI encoder v1 (port of ``deepinteraction_tpu/models/mmri_encoder.py``)
in the reference form:

- I2P keys come from every view (no top-2-view compaction), sampled
  bilinearly, over all pillars in one pass (no chunking) in eval;
- the BEVWarp depth scatter runs per view, the closest depth winning
  (``scatter_reduce(amin)``), then the exact depth fill;
- local attention runs on kernel K2 (``ops/local_attention.py``), forward
  and backward.

``train=True`` normalises with batch statistics. I2P then runs in chunks of
``I2P_CHUNK`` pillars, each under ``torch.utils.checkpoint``: the backward
samples a chunk's keys again instead of keeping every chunk's sampled keys
and their projections, as JAX rematerialises its chunk loop
(``mmri_encoder.py:152-154``, ``:328-337``). At the ``fusion_base`` train
capacity (30 000 pillars x 20 points x 6 views x 128 channels) one fp32
key tensor is 1.84 GB per sample and layer; keeping the sampled keys and
their three projections for autograd would hold about 30 GB at B=2.
The BEVWarp and I2P geometry depend on points and calibration only and
carry no gradient.

Layouts: images [B, V, H, W, C], BEV [B, Hb, Wb, C], channels last.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..configs import MMRIEncoderConfig

from ..ops.depth_fill import fill_in_multiscale
from ..ops.local_attention import local_attn_fwd
from ..utils.geometry import grid_sample_2d, transform_points
from .layers import Conv2d, ConvBNReLU

# pillars per rematerialised I2P chunk in train mode (the JAX chunk size)
I2P_CHUNK = 4096


class LocalContextAttentionBlock(nn.Module):
    """2-conv q/k projections, 1-conv v projection, k x k local attention."""

    def __init__(self, cin_target: int, cin_source: int, c: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.q0 = ConvBNReLU(cin_target, c, 1)
        self.q1 = ConvBNReLU(c, c, 1)
        self.k0 = ConvBNReLU(cin_source, c, 1)
        self.k1 = ConvBNReLU(c, c, 1)
        self.v = ConvBNReLU(cin_source, c, 1)

    def forward(self, target, source, train: bool = False):
        q = self.q1(self.q0(target, train), train)
        k = self.k1(self.k0(source, train), train)
        return local_attn_fwd(q, k, self.v(source, train), self.kernel)


def _project(hom, mat, input_shape):
    """Points [N, 4] through lidar2img [4, 4] -> normalised grid [N, 2],
    in-image mask [N], and (for BEVWarp) depth and pixel coords."""
    ih, iw = input_shape
    eps = 1e-5
    cam = hom @ mat.T
    depth = cam[:, 2]
    xy = cam[:, :2] / torch.clamp(cam[:, 2:3], min=eps)
    gx = (xy[:, 0] / iw - 0.5) * 2.0
    gy = (xy[:, 1] / ih - 0.5) * 2.0
    ok = (depth > eps) & (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
    return torch.stack([gx, gy], -1), ok, depth, xy


def i2p_geometry(pillars, pillar_counts, lidar2img, lidar_aug_inv, input_shape):
    """I2P sampling geometry over all views, shared by every layer.

    Returns (grids [B, V, Kp*P, 2], kmask [B, Kp, P*V]) with keys ordered
    (point, view), as the JAX all-view path orders them."""
    grids, kmasks = [], []
    for b in range(pillars.shape[0]):
        kp, p = pillars.shape[1], pillars.shape[2]
        raw = transform_points(lidar_aug_inv[b], pillars[b, ..., :3].reshape(kp * p, 3))
        hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
        g, ok = zip(*(_project(hom, m, input_shape)[:2] for m in lidar2img[b]))
        v = len(g)
        pt_ok = torch.arange(p, device=pillars.device)[None, :] < pillar_counts[b][:, None]
        ok = torch.stack(ok).reshape(v, kp, p).permute(1, 2, 0) & pt_ok[:, :, None]
        grids.append(torch.stack(g))
        kmasks.append(ok.reshape(kp, p * v))
    return torch.stack(grids), torch.stack(kmasks)


class MMRI_I2P(nn.Module):
    """Image-to-points: each pillar attends (one head, torch
    ``nn.MultiheadAttention`` projections) over the image features its raw
    points project to; the result is scattered back to the BEV grid."""

    def __init__(self, c: int):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def _attend(self, qh, feat, grid, kmask):
        """Pillar queries qh [n, C] over their keys: bilinear samples of
        ``feat`` [V, C, H, W] at ``grid`` [V, n*P, 2], masked by ``kmask``
        [n, P*V]. Returns (out [n, C], any_key [n])."""
        v, c = feat.shape[:2]
        n = qh.shape[0]
        sampled = F.grid_sample(
            feat, grid[:, None], mode="bilinear", padding_mode="zeros", align_corners=False
        )  # [V, C, 1, n*P]
        keys = sampled[:, :, 0].reshape(v, c, n, -1).permute(2, 3, 0, 1).reshape(n, -1, c)
        kh = self.k_proj(keys)
        vh = self.v_proj(keys)
        logits = torch.einsum("qc,qkc->qk", qh, kh)
        logits = torch.where(kmask, logits, logits.new_full((), float("-inf")))
        any_key = kmask.any(-1)
        attn = torch.softmax(logits, -1)
        attn = torch.where(any_key[:, None], attn, attn.new_zeros(()))
        return self.out_proj(torch.einsum("qk,qkc->qc", attn, vh)), any_key

    def forward(self, lidar_feat, img_feats, pillar_coords, pillar_valid, geom, train: bool = False):
        grids, kmask = geom
        b, hb, wb, c = lidar_feat.shape
        kp = pillar_coords.shape[1]
        p = grids.shape[2] // kp
        outs = []
        for i in range(b):
            coor = pillar_coords[i].long()
            qh = self.q_proj(lidar_feat[i][coor[:, 1], coor[:, 2]]) * (1.0 / math.sqrt(c))
            feat = img_feats[i].permute(0, 3, 1, 2)
            if train:
                parts = [
                    checkpoint(self._attend, qh[s:s + I2P_CHUNK], feat,
                               grids[i][:, s * p:(s + I2P_CHUNK) * p], kmask[i][s:s + I2P_CHUNK],
                               use_reentrant=False)
                    for s in range(0, kp, I2P_CHUNK)
                ]
                out, any_key = (torch.cat(t) for t in zip(*parts))
            else:
                out, any_key = self._attend(qh, feat, grids[i], kmask[i])
            has_key = any_key & pillar_valid[i]
            bev = lidar_feat.new_zeros(hb, wb, c)
            bev[coor[has_key, 1], coor[has_key, 2]] = out[has_key]
            outs.append(bev)
        return torch.stack(outs)


def _linspace(start: float, stop: float, n: int, device, dtype) -> torch.Tensor:
    """jnp.linspace's arithmetic: start + i * step, exact endpoint."""
    step = (stop - start) / (n - 1) if n > 1 else 0.0
    out = start + torch.arange(n, device=device, dtype=dtype) * step
    out[-1] = stop
    return out


def bevwarp_grid(points, points_mask, lidar2img, img2lidar, lidar_aug, lidar_aug_inv,
                 feat_shape, input_shape, pc_range):
    """BEVWarp geometry: per-view depth maps from the raw points (closest
    depth wins), densified, back-projected to normalised BEV coords.

    Returns (uv [B, V, hc, wc, 2], ok [B, V, hc, wc])."""
    hc, wc = feat_shape
    ih, iw = input_shape
    dev, dt = points.device, points.dtype
    pcr = torch.tensor(pc_range, dtype=dt, device=dev)
    gx = _linspace(0.0, iw - 1.0, wc, dev, dt)[None, :].expand(hc, wc)
    gy = _linspace(0.0, ih - 1.0, hc, dev, dt)[:, None].expand(hc, wc)
    uvs, oks = [], []
    for b in range(points.shape[0]):
        raw = transform_points(lidar_aug_inv[b], points[b, :, :3])
        hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
        v = lidar2img.shape[1]
        rows, cols, depths = [], [], []
        for vi in range(v):
            _, ok, depth, xy = _project(hom, lidar2img[b, vi], input_shape)
            ok = ok & points_mask[b]
            fx = torch.floor(xy[:, 0] / iw * wc).long()
            fy = torch.floor(xy[:, 1] / ih * hc).long()
            rows.append(vi * (hc + 1) + torch.where(ok, fy, torch.full_like(fy, hc)))
            cols.append(torch.where(ok, fx, torch.zeros_like(fx)))
            depths.append(torch.where(ok, depth, torch.full_like(depth, math.inf)))
        flat = (torch.cat(rows) * wc + torch.cat(cols))
        dm = torch.full((v * (hc + 1) * wc,), math.inf, dtype=dt, device=dev)
        # closest depth wins: deterministic whatever the write order
        dm = dm.scatter_reduce(0, flat, torch.cat(depths), reduce="amin")
        dms = dm.reshape(v, hc + 1, wc)[:, :hc]
        dms = torch.where(torch.isfinite(dms), dms, torch.zeros_like(dms))
        dms = fill_in_multiscale(dms)

        xyd = torch.stack([gx * dms, gy * dms, dms, torch.ones_like(dms)], -1)  # [V, hc, wc, 4]
        xyz = torch.einsum("vhwj,vij->vhwi", xyd, img2lidar[b])[..., :3]
        xyz = transform_points(lidar_aug[b], xyz)
        ok = (
            (xyz[..., 0] > pcr[0]) & (xyz[..., 1] > pcr[1]) & (xyz[..., 2] > pcr[2])
            & (xyz[..., 0] < pcr[3]) & (xyz[..., 1] < pcr[4]) & (xyz[..., 2] < pcr[5])
        )
        uv = (xyz[..., :2] - pcr[:2]) / (pcr[3:5] - pcr[:2])
        uvs.append((uv - 0.5) * 2.0)
        oks.append(ok)
    return torch.stack(uvs), torch.stack(oks)


def bev_warp(lidar_feat, grid):
    """Sample the BEV map at the warp grid: [B, V, hc, wc, C], 0 where the
    back-projected pixel leaves the point-cloud range."""
    uv, ok = grid
    warped = torch.stack([grid_sample_2d(lidar_feat[i], uv[i]) for i in range(uv.shape[0])])
    return torch.where(ok[..., None], warped, warped.new_zeros(()))


class MMRIEncoderLayer(nn.Module):
    """One bilateral interaction layer."""

    def __init__(self, cfg: MMRIEncoderConfig):
        super().__init__()
        c, k = cfg.hidden_channel, cfg.local_attn_kernel
        self.i2p = MMRI_I2P(c)
        self.p_iml = LocalContextAttentionBlock(c, c, c, k)
        self.p_out_proj = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.p_integration = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.p2i_local = LocalContextAttentionBlock(c, c, c, k)
        self.i_iml = LocalContextAttentionBlock(c, c, c, k)
        self.i_out_proj = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.i_integration = ConvBNReLU(2 * c, c, 1, use_act=False)

    def forward(self, img_feat, lidar_feat, batch, warp_grid, i2p_geom, train: bool = False):
        b, v = img_feat.shape[:2]
        i2p = self.i2p(lidar_feat, img_feat, batch["pillar_coords"], batch["pillar_valid"], i2p_geom, train)
        p2p = self.p_iml(lidar_feat, lidar_feat, train)
        p_aug = self.p_out_proj(torch.cat([i2p, p2p], -1), train)
        new_lidar = self.p_integration(torch.cat([p_aug, lidar_feat], -1), train)

        warped = bev_warp(lidar_feat, warp_grid)
        flat = img_feat.reshape(b * v, *img_feat.shape[2:])
        p2i = self.p2i_local(flat, warped.reshape(b * v, *warped.shape[2:]), train)
        i2i = self.i_iml(flat, flat, train)
        i_aug = self.i_out_proj(torch.cat([p2i, i2i], -1), train)
        new_img = self.i_integration(torch.cat([i_aug, flat], -1), train)
        return new_img.reshape(b, v, *new_img.shape[1:]), new_lidar


class MMRIEncoder(nn.Module):
    """Shared 3x3 convs to the hidden width, then ``num_layers`` interaction
    layers. Returns (new_img [B, V, h, w, C], (pts_feat_conv, new_pts))."""

    def __init__(self, cfg: MMRIEncoderConfig, cin_img: int, cin_pts: int,
                 pc_range: Tuple[float, ...], input_shape: Tuple[int, int]):
        super().__init__()
        c = cfg.hidden_channel
        self.pc_range = tuple(pc_range)
        self.input_shape = tuple(input_shape)
        self.num_layers = cfg.num_layers
        self.shared_conv_img = Conv2d(cin_img, c, 3, 1, 1)
        self.shared_conv_pts = Conv2d(cin_pts, c, 3, 1, 1)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", MMRIEncoderLayer(cfg))

    def forward(self, img_feats, pts_feats, batch: Dict[str, torch.Tensor], train: bool = False):
        b, v = img_feats.shape[:2]
        img = self.shared_conv_img(img_feats.reshape(b * v, *img_feats.shape[2:]))
        img = img.reshape(b, v, *img.shape[1:])
        pts = self.shared_conv_pts(pts_feats)
        pts_feat_conv = pts
        # geometry depends only on points and calibration: once per forward,
        # with no gradient
        with torch.no_grad():
            warp_grid = bevwarp_grid(
                batch["points"], batch["points_mask"], batch["lidar2img"], batch["img2lidar"],
                batch["lidar_aug"], batch["lidar_aug_inv"], img.shape[2:4], self.input_shape,
                self.pc_range,
            )
            geom = i2p_geometry(
                batch["pillars"], batch["pillar_counts"], batch["lidar2img"],
                batch["lidar_aug_inv"], self.input_shape,
            )
        for i in range(self.num_layers):
            img, pts = getattr(self, f"layer{i}")(img, pts, batch, warp_grid, geom, train)
        return img, (pts_feat_conv, pts)
