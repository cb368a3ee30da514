"""DeepInteraction++ MMRI encoder, ``FusionTransformerPP`` (port of
``deepinteraction_tpu/models/fusion_transformer.py``), with the JAX
package's settings (``levers.py``) as the v1 encoder takes them, and the
deformable attentions' top-k points in eval.

A shared 3x3 conv on the 512-channel LiDAR concat map (``pts_feat_conv``),
3x3 convs to the hidden width on the two image levels and the two BEV
levels, then ``num_layers`` pairs of interaction layers on the level-0
maps, each with the multi-scale token sets as its deformable-attention
values:

- image layer: MSDA over the image levels, then BEVWarp + single-level
  MSDA (``MMRI_P2I_PP``), combined as ``self_feat + scale * cross_feat``;
- LiDAR layer: MSDA over the BEV levels, then the polar-ray I2P
  (``PolarI2P``) and the pillar I2P (``MMRI_I2P``, added as a residual).

The BEVWarp grid (at the level-0 image size) and the I2P geometry depend
on points and calibration only: they are computed once per forward, with no
gradient, and shared by every layer. None of this is a Pallas kernel in the
JAX package; it is plain PyTorch.

Under ``train=True`` each interaction layer is recomputed in the backward
(:func:`recomputed`, ``torch.utils.checkpoint``), as JAX remats them
(``fusion_transformer.py:391-400``): only the layers' inputs are kept, not
the deformable-attention and polar-decoder intermediates of the 268 800
image tokens of a B=2 step. The pillar I2P inside a LiDAR layer recomputes
per chunk in its turn (``MMRI_I2P``): checkpoint inside checkpoint.

Dropout in train mode: the deformable attentions at their own rate, 0.1
(mmcv's default, which the reference config leaves as it is, and the JAX
modules too), the FFNs and the polar decoder at ``cfg.dropout``.

Layouts: images [B, V, h, w, C], BEV [B, Hb, Wb, C], channels last.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import MMRIEncoderConfig
from ..ops.deform_attn import MSDeformableAttention
from ..utils.geometry import grid_sample_2d, transform_points
from .layers import Conv2d, TorchMHA, TransFFN
from .mmri_encoder import MMRI_I2P, bev_warp, bevwarp_grid, i2p_geometry


# the image pixels per feature column of FPN level 0 (its stride), at
# which PolarI2P casts its rays
IM_SCALE = 4.0


@functools.lru_cache(maxsize=16)
def sine_pos_2d(h: int, w: int, num_feats: int, device: torch.device,
                temperature: float = 10000.0) -> torch.Tensor:
    """DETR sine positions [h, w, 2 * num_feats] (the y half first),
    computed in float64 as the JAX package computes them, then cast to
    float32; made once per shape and device and kept there (read only)."""
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)  # float64

    def embed(v):
        p = v[:, None] / dim_t[None, :]
        out = np.empty_like(p)
        out[:, 0::2] = np.sin(p[:, 0::2])
        out[:, 1::2] = np.cos(p[:, 1::2])
        return out

    ye = np.broadcast_to(embed(ys)[:, None, :], (h, w, num_feats))
    xe = np.broadcast_to(embed(xs)[None, :, :], (h, w, num_feats))
    return torch.from_numpy(np.concatenate([ye, xe], -1).astype(np.float32)).to(device)


def _ref_points(hq: int, wq: int, n: int, levels: int, device, dtype=torch.float32) -> torch.Tensor:
    """Pixel-centre reference points [n, hq*wq, levels, 2] as (x, y) in [0, 1]."""
    ys = (torch.arange(hq, dtype=dtype, device=device) + 0.5) / hq
    xs = (torch.arange(wq, dtype=dtype, device=device) + 0.5) / wq
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ref = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    return ref[None, :, None, :].expand(n, hq * wq, levels, 2)


class MMRI_P2I_PP(nn.Module):
    """BEVWarp, then single-level deformable attention of the image pixels
    over the warped LiDAR map."""

    def __init__(self, cfg: MMRIEncoderConfig, msda_joint_points: int = 0, msda_eval_points: int = 0):
        super().__init__()
        c = cfg.hidden_channel
        self.local = MSDeformableAttention(c, cfg.num_heads, 1, cfg.deform_num_points,
                                           joint_points=msda_joint_points, eval_points=msda_eval_points)

    def forward(self, img_map, pts_map, warp_grid, train: bool = False, generator=None):
        b, v, h, w, c = img_map.shape
        warped = bev_warp(pts_map, warp_grid)
        ref = _ref_points(h, w, b * v, 1, img_map.device, img_map.dtype)
        out = self.local(img_map.reshape(b * v, h * w, c), warped.reshape(b * v, h * w, c), ref, [(h, w)],
                         train=train, generator=generator)
        return out.reshape(b, v, h, w, c)


class PolarI2P(nn.Module):
    """Polar-ray image-to-points interaction. Per view, one query per
    (image column, radius bin), sampled from the LiDAR map at the ray's
    point plus sine positions, runs one post-norm transformer decoder layer
    over its column's pixels; the rays are splatted back onto the BEV grid
    (a BEV cell samples the ray map at its column and radius, averaged over
    ``num_z_bins`` heights), averaged over the views that see the cell, and
    added to the input map. The views share the weights and run as one
    batch: the decoder's batch is (sample, view, column)."""

    def __init__(self, cfg: MMRIEncoderConfig, pc_range, input_shape,
                 radius_range=(1.0, 61.0, 1.0), num_z_bins: int = 10):
        super().__init__()
        c = cfg.hidden_channel
        self.pc_range, self.input_shape = tuple(pc_range), tuple(input_shape)
        self.radius_range, self.num_z_bins = tuple(radius_range), num_z_bins
        self.dec_self_attn = TorchMHA(c, cfg.num_heads, cfg.dropout)
        self.dec_cross_attn = TorchMHA(c, cfg.num_heads, cfg.dropout)
        self.dec_ffn = TransFFN(c, 4 * c, cfg.dropout)
        self.dec_norm1, self.dec_norm2, self.dec_norm3 = nn.LayerNorm(c), nn.LayerNorm(c), nn.LayerNorm(c)
        self.dec_out_norm = nn.LayerNorm(c)
        self.enc_out_norm = nn.LayerNorm(c)

    def _decode(self, tgt, mem, train, generator):
        """Post-norm torch ``TransformerDecoderLayer`` + the decoder norm."""
        tgt = self.dec_norm1(tgt + self.dec_self_attn(tgt, tgt, tgt, train=train, generator=generator))
        tgt = self.dec_norm2(tgt + self.dec_cross_attn(tgt, mem, mem, train=train, generator=generator))
        return self.dec_out_norm(self.dec_norm3(self.dec_ffn(tgt, train, generator)))

    def forward(self, pts_map, img_map, batch: Dict[str, torch.Tensor], train: bool = False, generator=None):
        b, v, h, w, c = img_map.shape
        hb, wb = pts_map.shape[1:3]
        r0, r1, rstep = self.radius_range
        r = int((r1 - r0) / rstep)
        ih, iw = self.input_shape
        dev, dt = pts_map.device, pts_map.dtype
        pcr = torch.tensor(self.pc_range, dtype=dt, device=dev)
        img_pos = sine_pos_2d(h, w, c // 2, dev)  # [h, w, C]
        ray_pos = sine_pos_2d(r, w, c // 2, dev)  # [r, w, C]
        depths = r0 + rstep * (torch.arange(r, dtype=dt, device=dev) + 0.5)  # bin centres

        # the BEV cells (x, y) at num_z_bins heights, in the model frame
        def centres(n, lo, hi):
            return (torch.arange(n, dtype=dt, device=dev) + 0.5) / n * (hi - lo) + lo

        gy, gx, gz = torch.meshgrid(centres(hb, pcr[1], pcr[4]), centres(wb, pcr[0], pcr[3]),
                                    centres(self.num_z_bins, pcr[2], pcr[5]), indexing="ij")
        cells = torch.stack([gx, gy, gz], -1)  # [hb, wb, z, 3]
        # one ray per feature column, through the pixel row at mid-height
        u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * IM_SCALE
        pix = torch.stack([u, torch.full_like(u, (h // 2) * IM_SCALE), torch.ones_like(u),
                           torch.ones_like(u)], -1).to(dt)  # [w, 4]

        out = []
        for i in range(b):
            l2i, i2l, cam_t = batch["lidar2img"][i], batch["img2lidar"][i], batch["cam2lidar"][i, :, :3, 3]
            d = torch.einsum("wj,vij->vwi", pix, i2l)[..., :2] - cam_t[:, None, :2]  # [V, w, 2]
            ray_dir = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
            ctr = depths[None, :, None, None] * ray_dir[:, None]  # [V, r, w, 2]
            ctr = transform_points(batch["lidar_aug"][i], torch.cat([ctr, torch.zeros_like(ctr[..., :1])], -1))
            gxy = (ctr[..., :2] - pcr[:2]) / (pcr[3:5] - pcr[:2])
            polar_q = grid_sample_2d(pts_map[i], gxy * 2.0 - 1.0) + ray_pos  # [V, r, w, C]

            mem = self.enc_out_norm((img_map[i] + img_pos).transpose(1, 2))  # [V, w, h, C]
            tgt = polar_q.transpose(1, 2).reshape(v * w, r, c)
            rays = self._decode(tgt, mem.reshape(v * w, h, c), train, generator)
            rays = rays.reshape(v, w, r, c).permute(0, 3, 2, 1)  # [V, C, r, w]

            # splat back: project the cells into each view
            raw = transform_points(batch["lidar_aug_inv"][i], cells)
            cam = torch.einsum("hwzj,vij->vhwzi", torch.cat([raw, torch.ones_like(raw[..., :1])], -1), l2i)
            eps = 1e-5
            xy = cam[..., :2] / torch.clamp(cam[..., 2:3], min=eps)
            gxn = xy[..., 0] / iw * 2.0 - 1.0
            gyn = xy[..., 1] / ih * 2.0 - 1.0
            ok = (cam[..., 2] > eps) & (gxn > -1) & (gxn < 1) & (gyn > -1) & (gyn < 1)
            radius = torch.linalg.norm(raw[None, ..., :2] - cam_t[:, None, None, None, :2], dim=-1)
            # normalised by the metric span r1 - r0 (r * rstep), not the bin count
            rn = torch.clamp(2.0 * (radius - r0) / (r1 - r0) - 1.0, -1.0, 1.0)
            # the plain mean over all z bins, in view or not (the reference's
            # unmasked mean); visibility gates only the splat and the count
            loc = torch.stack([gxn, rn], -1).mean(3)  # [V, hb, wb, 2]
            vis = ok.any(3)  # [V, hb, wb]
            sampled = F.grid_sample(rays, loc, mode="bilinear", padding_mode="zeros", align_corners=False)
            sampled = torch.where(vis[..., None], sampled.permute(0, 2, 3, 1), sampled.new_zeros(()))
            cnt = torch.clamp(vis.sum(0), min=1)[..., None]
            out.append(sampled.sum(0) / cnt)
        return torch.stack(out) + pts_map


class FusionLayerImg(nn.Module):
    """Image-branch interaction layer: MSDA over the image levels, then
    ``MMRI_P2I_PP``; ``self_feat + scale * cross_feat``."""

    def __init__(self, cfg: MMRIEncoderConfig, msda_joint_points: int = 0, msda_eval_points: int = 0):
        super().__init__()
        c = cfg.hidden_channel
        self.self_attn = MSDeformableAttention(c, cfg.num_heads, cfg.num_levels, cfg.deform_num_points,
                                               joint_points=msda_joint_points, eval_points=msda_eval_points)
        self.norm0 = nn.LayerNorm(c)
        self.p2i = MMRI_P2I_PP(cfg, msda_joint_points, msda_eval_points)
        self.norm1 = nn.LayerNorm(c)
        self.ffn0 = TransFFN(c, 4 * c, cfg.dropout)
        self.norm2 = nn.LayerNorm(c)
        self.ffn1 = TransFFN(c, 4 * c, cfg.dropout)
        self.norm3 = nn.LayerNorm(c)
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, img_map, pts_map, ms_tokens, ref, shapes, warp_grid, train: bool = False,
                generator=None):
        b, v, h, w, c = img_map.shape
        q = self.self_attn(img_map.reshape(b * v, h * w, c), ms_tokens, ref, shapes, train=train,
                           generator=generator)
        self_feat = q
        q = self.p2i(self.norm0(q).reshape(b, v, h, w, c), pts_map, warp_grid, train, generator)
        q = self.norm2(self.ffn0(self.norm1(q.reshape(b * v, h * w, c)), train, generator))
        self_feat = self.norm3(self.ffn1(self_feat, train, generator))
        return (self_feat + self.scale * q).reshape(b, v, h, w, c)


class FusionLayerPts(nn.Module):
    """LiDAR-branch interaction layer: MSDA over the BEV levels, then the
    polar I2P (when ``use_polar_i2p``, with ``norm1``) and the pillar I2P
    as a residual; ``self_feat + scale * cross_feat``."""

    def __init__(self, cfg: MMRIEncoderConfig, pc_range, input_shape, i2p_views: int = 0,
                 i2p_sample: str = "bilinear", msda_joint_points: int = 0, msda_eval_points: int = 0):
        super().__init__()
        c = cfg.hidden_channel
        self.self_attn = MSDeformableAttention(c, cfg.num_heads, cfg.num_levels, cfg.deform_num_points,
                                               joint_points=msda_joint_points, eval_points=msda_eval_points)
        self.norm0 = nn.LayerNorm(c)
        self.use_polar_i2p = cfg.use_polar_i2p
        if cfg.use_polar_i2p:
            self.polar_i2p = PolarI2P(cfg, pc_range, input_shape, cfg.polar_radius_range,
                                      cfg.polar_num_z_bins)
            self.norm1 = nn.LayerNorm(c)
        # JAX's ++ neck samples its keys per chunk (no hoisted geometry),
        # where the key dedupe does not apply
        self.i2p = MMRI_I2P(c, i2p_views, i2p_sample)
        self.norm2 = nn.LayerNorm(c)
        self.ffn0 = TransFFN(c, 4 * c, cfg.dropout)
        self.norm3 = nn.LayerNorm(c)
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, pts_map, img_map, ms_tokens, ref, shapes, batch, i2p_geom, train: bool = False,
                generator=None):
        b, hb, wb, c = pts_map.shape
        q = self.self_attn(pts_map.reshape(b, hb * wb, c), ms_tokens, ref, shapes, train=train,
                           generator=generator)
        self_feat = q
        qm = self.norm0(q).reshape(b, hb, wb, c)
        if self.use_polar_i2p:
            qm = self.norm1(self.polar_i2p(qm, img_map, batch, train, generator))
        qm = qm + self.i2p(qm, img_map, batch["pillar_coords"], batch["pillar_valid"], i2p_geom, train)
        q = self.norm2(qm.reshape(b, hb * wb, c))
        self_feat = self.norm3(self.ffn0(self_feat, train, generator))
        return (self_feat + self.scale * q).reshape(b, hb, wb, c)


def recomputed(layer: nn.Module, generator: torch.Generator | None, *args):
    """``layer(*args, True, generator)`` (train mode) under
    ``torch.utils.checkpoint`` (non-reentrant): the backward runs the
    layer's forward again for its intermediates.

    ``checkpoint`` restores the global CPU and CUDA generators for the
    recompute, not the explicit ``generator`` every dropout here draws from:
    the recompute would draw new masks and the gradients would belong to
    another forward. So the generator's state is snapshotted
    (``get_state``) at the call; the recompute starts from the snapshot,
    draws the forward's masks again, and then puts back the state it found,
    so the caller's generator ends the backward where the forward left it."""
    if generator is None:
        return checkpoint(layer, *args, True, None, use_reentrant=False)
    start = generator.get_state()
    ran = []

    def run(*a):
        if not ran:  # the forward
            ran.append(True)
            return layer(*a, True, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, True, generator)
        finally:  # also when checkpoint stops the recompute early
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class FusionTransformerPP(nn.Module):
    """Returns (new_img [B, V, h0, w0, C], (pts_feat_conv, new_pts)).

    The JAX package's settings (``levers.py``) come in as arguments, each 0
    or off by default (the reference's math): ``i2p_views`` and
    ``i2p_sample`` for the pillar I2P and its geometry, ``warp_views`` and
    ``depth_fill_lite`` (eval only) for the BEVWarp grid, and the
    deformable attentions' ``msda_joint_points`` and ``msda_eval_points``
    (eval only)."""

    def __init__(self, cfg: MMRIEncoderConfig, cin_img: int, cin_pts: int, cin_pts_level: int,
                 pc_range: Tuple[float, ...], input_shape: Tuple[int, int], i2p_views: int = 0,
                 i2p_sample: str = "bilinear", warp_views: int = 0, depth_fill_lite: bool = False,
                 msda_joint_points: int = 0, msda_eval_points: int = 0):
        super().__init__()
        c = cfg.hidden_channel
        self.cfg, self.pc_range, self.input_shape = cfg, tuple(pc_range), tuple(input_shape)
        self.i2p_views, self.warp_views, self.depth_fill_lite = i2p_views, warp_views, depth_fill_lite
        self.shared_conv_pts = Conv2d(cin_pts, c, 3, 1, 1)
        self.multi_scale_conv_img = Conv2d(cin_img, c, 3, 1, 1)
        self.multi_scale_conv_pts = Conv2d(cin_pts_level, c, 3, 1, 1)
        for i in range(cfg.num_layers):
            self.add_module(f"img_layer{i}", FusionLayerImg(cfg, msda_joint_points, msda_eval_points))
            self.add_module(f"pts_layer{i}", FusionLayerPts(cfg, pc_range, input_shape, i2p_views, i2p_sample,
                                                            msda_joint_points, msda_eval_points))

    def forward(self, ms_img_feats: Sequence[torch.Tensor], pts_feats: Sequence[torch.Tensor],
                batch: Dict[str, torch.Tensor], train: bool = False, generator=None):
        """ms_img_feats: the image levels [B, V, h_l, w_l, Cin]; pts_feats:
        the SECONDFPN outputs [concat, up0, up1]."""
        cfg = self.cfg
        c = cfg.hidden_channel
        b, v = ms_img_feats[0].shape[:2]
        pts_feat_conv = self.shared_conv_pts(pts_feats[0])
        ms_img = [self.multi_scale_conv_img(f.reshape(b * v, *f.shape[2:])) for f in ms_img_feats]
        ms_pts = [self.multi_scale_conv_pts(f) for f in pts_feats[1:]]
        img_shapes = [tuple(f.shape[1:3]) for f in ms_img]
        pts_shapes = [tuple(f.shape[1:3]) for f in ms_pts]
        img_tokens = torch.cat([f.reshape(b * v, -1, c) for f in ms_img], 1)
        pts_tokens = torch.cat([f.reshape(b, -1, c) for f in ms_pts], 1)
        dev, dt = pts_feat_conv.device, pts_feat_conv.dtype
        ref_img = _ref_points(*img_shapes[0], b * v, cfg.num_levels, dev, dt)
        ref_pts = _ref_points(*pts_shapes[0], b, cfg.num_levels, dev, dt)
        with torch.no_grad():
            warp_grid = bevwarp_grid(
                batch["points"], batch["points_mask"], batch["lidar2img"], batch["img2lidar"],
                batch["lidar_aug"], batch["lidar_aug_inv"], img_shapes[0], self.input_shape, self.pc_range,
                self.warp_views, self.depth_fill_lite and not train,
            )
            i2p_geom = i2p_geometry(batch["pillars"], batch["pillar_counts"], batch["lidar2img"],
                                    batch["lidar_aug_inv"], self.input_shape, self.i2p_views)

        new_img = ms_img[0].reshape(b, v, *ms_img[0].shape[1:])
        new_pts = ms_pts[0]
        for i in range(cfg.num_layers):
            img_args = (new_img, new_pts, img_tokens, ref_img, img_shapes, warp_grid)
            pts_args = (new_pts, new_img, pts_tokens, ref_pts, pts_shapes, batch, i2p_geom)
            img_layer, pts_layer = getattr(self, f"img_layer{i}"), getattr(self, f"pts_layer{i}")
            if train:
                new_img, new_pts = (recomputed(img_layer, generator, *img_args),
                                    recomputed(pts_layer, generator, *pts_args))
            else:
                new_img, new_pts = img_layer(*img_args), pts_layer(*pts_args)
        return new_img, (pts_feat_conv, new_pts)
