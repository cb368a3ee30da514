"""MMRI encoder v1 (port of ``deepinteraction_tpu/models/mmri_encoder.py``):

- I2P keys come from every view, or from each pillar's top views
  (``i2p_views``), sampled bilinearly or, in eval, at the nearest pixel,
  optionally deduplicated, in fp32 or bf16 (``i2p_dtype``); over all
  pillars in one pass (no chunking) in eval;
- the BEVWarp depth scatter runs over every view or each point's top
  views (``warp_views``), the closest depth winning
  (``scatter_reduce(amin)``), then the depth fill, exact or lite;
- local attention runs on kernel K2 (``ops/local_attention.py``), forward
  and backward; with ``bf16``, its forward on K2's bf16 variant (the JAX
  package's default ``DI_LOCATT_MXU=bf16`` on a TPU), its backward fp32.

The settings are the JAX package's ``DI_*`` ones (``levers.py``); with
each off, the module computes the reference's math.

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

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..configs import MMRIEncoderConfig

from ..ops.depth_fill import fill_in_multiscale
from ..ops.local_attention import local_attn_fwd
from ..utils.geometry import (
    grid_sample_2d,
    grid_sample_2d_views,
    grid_sample_2d_views_nearest,
    nearest_row_ids,
    take_rows,
    transform_points,
)
from ..utils.spans import grad_span, span
from .layers import Conv2d, ConvBNReLU

# pillars per rematerialised I2P chunk in train mode (the JAX chunk size)
I2P_CHUNK = 4096
# the I2P key dtypes (DI_I2P_DTYPE)
I2P_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    def forward(self, target, source, train: bool = False, bf16: bool = False):
        q = self.q1(self.q0(target, train), train)
        k = self.k1(self.k0(source, train), train)
        return local_attn_fwd(q, k, self.v(source, train), self.kernel, bf16=bf16)


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


def _top_views(counts: torch.Tensor, n: int) -> torch.Tensor:
    """[..., V] per-view scores -> [..., n] the views picked by ``n`` rounds
    of argmax, each round's pick set to -1 for the next (JAX's iterative
    argmax, ``mmri_encoder.py:416-421``): most first, ties to the lowest
    view index."""
    rem = counts.long()
    picks = []
    for _ in range(n):
        vi = torch.argmax(rem, -1)  # the first of equal maxima
        picks.append(vi)
        rem = rem.scatter(-1, vi[..., None], -1)
    return torch.stack(picks, -1)


def i2p_geometry(pillars, pillar_counts, lidar2img, lidar_aug_inv, input_shape, n_views: int = 0):
    """I2P sampling geometry, shared by every layer.

    With ``n_views`` 0 or at least V, every view: returns (grids
    [B, V, Kp*P, 2], kmask [B, Kp, P*V]), keys ordered (point, view) as the
    JAX all-view path orders them. With 0 < ``n_views`` < V, each pillar's
    ``n_views`` views with the most valid hits (:func:`_top_views`; a
    pillar with fewer views hit still picks some, masked out): returns
    (gsel [B, Kp, nv, P, 2], vidx [B, Kp, nv, P], kmask [B, Kp, nv*P]),
    keys ordered (view, point), as JAX's hoisted ``i2p_geometry``."""
    out = []
    for b in range(pillars.shape[0]):
        kp, p = pillars.shape[1], pillars.shape[2]
        raw = transform_points(lidar_aug_inv[b], pillars[b, ..., :3].reshape(kp * p, 3))
        hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
        g, ok = zip(*(_project(hom, m, input_shape)[:2] for m in lidar2img[b]))
        v = len(g)
        pt_ok = torch.arange(p, device=pillars.device)[None, :] < pillar_counts[b][:, None]
        ok = torch.stack(ok).reshape(v, kp, p) & pt_ok  # [V, Kp, P]
        if 0 < n_views < v:
            vsel = _top_views(ok.sum(2).T, n_views)  # [Kp, nv]
            rows = torch.arange(kp, device=pillars.device)[:, None]
            gsel = torch.stack(g).reshape(v, kp, p, 2).transpose(0, 1)[rows, vsel]  # [Kp, nv, P, 2]
            kmask = ok.transpose(0, 1)[rows, vsel].reshape(kp, n_views * p)
            out.append((gsel, vsel[:, :, None].expand(kp, n_views, p), kmask))
        else:
            out.append((torch.stack(g), ok.permute(1, 2, 0).reshape(kp, p * v)))
    return tuple(torch.stack(t) for t in zip(*out))


class MMRI_I2P(nn.Module):
    """Image-to-points: each pillar attends (one head, torch
    ``nn.MultiheadAttention`` projections) over the image features its raw
    points project to; the result is scattered back to the BEV grid.

    ``n_views`` > 0 takes the keys of each pillar's top views from a
    top-view :func:`i2p_geometry` (the JAX package's ``DI_I2P_VIEWS``, in
    train and eval). ``sample_mode="nearest"`` samples the keys at the
    nearest pixel in eval (``DI_I2P_SAMPLE``; train samples bilinear).
    ``dedupe`` > 0, in eval with nearest sampling and top views only
    (``DI_I2P_DEDUPE``): each (pillar, view) gathers only its first
    ``dedupe`` distinct pixels, in row order, and adds log(count) to their
    logits, which is exact while no (pillar, view) has more distinct
    pixels (softmax over a multiset is softmax over its distinct members
    with log-multiplicity logits).

    ``dtype="bfloat16"`` (``DI_I2P_DTYPE``, train and eval) follows JAX's
    dtype flow (``mmri_encoder.py:164-179``): the image features, and so
    the sampled keys, are rounded to bf16; the key and value projections
    run in bf16 with bf16 weights and biases (the product rounded, then the
    bias added, as JAX does); the queries stay fp32 until they are rounded
    to bf16 for the logits; the logits and the weighted sum of the values
    take bf16 inputs (the attention weights rounded to bf16) and
    accumulate in fp32, which the port computes by upcasting the bf16
    inputs (a product of two bf16 values is exact in fp32, so this is
    JAX's ``preferred_element_type=float32``); the softmax and the output
    projection run in fp32."""

    def __init__(self, c: int, n_views: int = 0, sample_mode: str = "bilinear", dedupe: int = 0,
                 dtype: str = "float32"):
        super().__init__()
        self.n_views, self.sample_mode, self.dedupe = n_views, sample_mode, dedupe
        self.key_dtype = I2P_DTYPES[dtype]
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def _attend(self, qh, keys, kmask, bias=None):
        """Pillar queries qh [n, C] over their keys [n, K, C], masked by
        ``kmask`` [n, K], logits plus ``bias`` [n, K] if given. Returns
        (out [n, C], any_key [n])."""
        if self.key_dtype == torch.float32:
            kh = self.k_proj(keys)
            vh = self.v_proj(keys)
        else:
            keys, qh = keys.to(self.key_dtype), qh.to(self.key_dtype).float()
            kh, vh = (keys @ proj.weight.to(self.key_dtype).T + proj.bias.to(self.key_dtype)
                      for proj in (self.k_proj, self.v_proj))
            kh, vh = kh.float(), vh.float()
        logits = torch.einsum("qc,qkc->qk", qh, kh)
        if bias is not None:
            logits = logits + bias
        logits = torch.where(kmask, logits, logits.new_full((), float("-inf")))
        any_key = kmask.any(-1)
        attn = torch.softmax(logits, -1)
        attn = torch.where(any_key[:, None], attn, attn.new_zeros(()))
        if self.key_dtype != torch.float32:
            attn = attn.to(self.key_dtype).float()
        return self.out_proj(torch.einsum("qk,qkc->qc", attn, vh)), any_key

    def _from_all_views(self, qh, feat, grid, kmask, nearest: bool):
        """Keys from every view: ``feat`` [V, H, W, C] sampled at ``grid``
        [V, n*P, 2], ordered (point, view); ``kmask`` [n, P*V]."""
        v, c = feat.shape[0], feat.shape[-1]
        n = qh.shape[0]
        if nearest:
            view = torch.arange(v, device=grid.device)[:, None].expand(grid.shape[:2])
            sampled = grid_sample_2d_views_nearest(feat, grid, view)  # [V, n*P, C]
            keys = sampled.reshape(v, n, -1, c).permute(1, 2, 0, 3).reshape(n, -1, c)
        else:
            sampled = F.grid_sample(
                feat.permute(0, 3, 1, 2).to(grid.dtype), grid[:, None], mode="bilinear", padding_mode="zeros",
                align_corners=False,
            )  # [V, C, 1, n*P]
            keys = sampled[:, :, 0].reshape(v, c, n, -1).permute(2, 3, 0, 1).reshape(n, -1, c)
        return self._attend(qh, keys, kmask)

    def _from_top_views(self, qh, feat, gsel, vidx, kmask, nearest: bool):
        """Keys from each pillar's top views: ``feat`` [V, H, W, C] sampled
        at ``gsel`` [n, nv, P, 2] in views ``vidx`` [n, nv, P], ordered
        (view, point); ``kmask`` [n, nv*P]."""
        n, nv, p = vidx.shape
        c = feat.shape[-1]
        sampler = grid_sample_2d_views_nearest if nearest else grid_sample_2d_views
        keys = sampler(feat, gsel, vidx).reshape(n, nv * p, c)
        return self._attend(qh, keys, kmask)

    def _deduped(self, qh, feat, gsel, vidx, kmask):
        """The top-view keys at their nearest pixels, each (pillar, view)'s
        first ``dedupe`` distinct pixels gathered once and weighted by their
        count (JAX ``mmri_encoder.py:216-256``)."""
        v, h, w, c = feat.shape
        n, nv, p = vidx.shape
        dd = self.dedupe
        ids, inside = nearest_row_ids((v, h, w), gsel, vidx)
        valid = kmask.reshape(n, nv, p) & inside
        big = v * h * w  # invalid keys sort last
        sids = torch.sort(torch.where(valid, ids, torch.full_like(ids, big)), -1).values
        ok = sids < big
        first = torch.ones_like(ok)
        first[..., 1:] = sids[..., 1:] != sids[..., :-1]
        first &= ok
        rank = torch.cumsum(first.long(), -1) - 1  # [n, nv, P]: the slot of each key's pixel
        slot = (rank[..., None] == torch.arange(dd, device=rank.device)) & ok[..., None]  # [n, nv, P, dd]
        counts = slot.sum(-2)  # [n, nv, dd]
        slot_ids = ((slot & first[..., None]).long() * sids[..., None]).sum(-2)  # [n, nv, dd]
        keys = take_rows(feat.reshape(big, c), slot_ids).reshape(n, nv * dd, c)
        live = (counts > 0).reshape(n, nv * dd)
        bias = torch.where(live, torch.log(counts.clamp(min=1).to(qh.dtype)).reshape(n, nv * dd),
                           qh.new_zeros(()))
        return self._attend(qh, keys, live, bias)

    def forward(self, lidar_feat, img_feats, pillar_coords, pillar_valid, geom, train: bool = False):
        """``geom``: :func:`i2p_geometry`'s all-view pair or top-view triple."""
        b, hb, wb, c = lidar_feat.shape
        kp = pillar_coords.shape[1]
        top = len(geom) == 3
        nearest = self.sample_mode == "nearest" and not train
        if top:
            attend = self._deduped if (nearest and self.dedupe > 0) else functools.partial(
                self._from_top_views, nearest=nearest)
        else:
            attend = functools.partial(self._from_all_views, nearest=nearest)
        outs = []
        for i in range(b):
            coor = pillar_coords[i].long()
            qh = self.q_proj(lidar_feat[i][coor[:, 1], coor[:, 2]]) * (1.0 / math.sqrt(c))
            feat = img_feats[i].to(self.key_dtype)
            if top:
                args = tuple(t[i] for t in geom)
                chunk = lambda s, e: tuple(t[s:e] for t in args)  # noqa: E731
            else:
                grid, kmask = geom[0][i], geom[1][i]
                p = grid.shape[1] // kp
                chunk = lambda s, e: (grid[:, s * p:e * p], kmask[s:e])  # noqa: E731
            if train:
                parts = [
                    checkpoint(attend, qh[s:s + I2P_CHUNK], feat, *chunk(s, s + I2P_CHUNK), use_reentrant=False)
                    for s in range(0, kp, I2P_CHUNK)
                ]
                out, any_key = (torch.cat(t) for t in zip(*parts))
            else:
                out, any_key = attend(qh, feat, *chunk(0, kp))
            has_key = any_key & pillar_valid[i]
            bev = lidar_feat.new_zeros(hb, wb, c)
            with span("di.sync.i2p.values"):
                vals = grad_span(out[has_key], "di.sync.i2p.values.grad")
            with span("di.sync.i2p.rows"):
                rows = coor[has_key, 1]
            with span("di.sync.i2p.cols"):
                cols = coor[has_key, 2]
            bev[rows, cols] = vals
            outs.append(bev)
        return torch.stack(outs)


def _linspace(start: float, stop: float, n: int, device, dtype) -> torch.Tensor:
    """jnp.linspace's arithmetic: start + i * step, exact endpoint."""
    step = (stop - start) / (n - 1) if n > 1 else 0.0
    out = start + torch.arange(n, device=device, dtype=dtype) * step
    with span("di.sync.linspace.end"):
        out[-1] = stop
    return out


def bevwarp_grid(points, points_mask, lidar2img, img2lidar, lidar_aug, lidar_aug_inv,
                 feat_shape, input_shape, pc_range, warp_views: int = 0, depth_fill_lite: bool = False):
    """BEVWarp geometry: per-view depth maps from the raw points (closest
    depth wins), densified, back-projected to normalised BEV coords.

    With 0 < ``warp_views`` < V each point enters the depth maps of its
    first ``warp_views`` views that see it (JAX ``DI_WARP_VIEWS``,
    ``mmri_encoder.py:499-528``; a point that no view sees falls to a
    trash row, as in the all-view scatter). ``depth_fill_lite`` is the
    lite fill (:func:`fill_in_multiscale`); callers pass it in eval only.

    Returns (uv [B, V, hc, wc, 2], ok [B, V, hc, wc])."""
    hc, wc = feat_shape
    ih, iw = input_shape
    dev, dt = points.device, points.dtype
    with span("di.sync.bevwarp.pc_range"):
        pcr = torch.tensor(pc_range, dtype=dt, device=dev)
    gx = _linspace(0.0, iw - 1.0, wc, dev, dt)[None, :].expand(hc, wc)
    gy = _linspace(0.0, ih - 1.0, hc, dev, dt)[:, None].expand(hc, wc)
    uvs, oks = [], []
    for b in range(points.shape[0]):
        raw = transform_points(lidar_aug_inv[b], points[b, :, :3])
        hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
        v = lidar2img.shape[1]
        rows, cols, depths, oks_v = [], [], [], []
        for vi in range(v):
            _, ok, depth, xy = _project(hom, lidar2img[b, vi], input_shape)
            oks_v.append(ok & points_mask[b])
            cols.append(torch.floor(xy[:, 0] / iw * wc).long())
            rows.append(torch.floor(xy[:, 1] / ih * hc).long())
            depths.append(depth)
        ok, fx, fy, depth = (torch.stack(t) for t in (oks_v, cols, rows, depths))  # each [V, N]
        view = torch.arange(v, device=dev)[:, None].expand(v, ok.shape[1])
        if 0 < warp_views < v:
            vsel = _top_views(ok.T, warp_views).T  # [nv, N]
            ok, fx, fy, depth = (t.gather(0, vsel) for t in (ok, fx, fy, depth))
            view = vsel
        row = view * (hc + 1) + torch.where(ok, fy, torch.full_like(fy, hc))
        flat = row * wc + torch.where(ok, fx, torch.zeros_like(fx))
        dm = torch.full((v * (hc + 1) * wc,), math.inf, dtype=dt, device=dev)
        # closest depth wins: deterministic whatever the write order
        depth = torch.where(ok, depth, torch.full_like(depth, math.inf))
        dm = dm.scatter_reduce(0, flat.reshape(-1), depth.reshape(-1), reduce="amin")
        dms = dm.reshape(v, hc + 1, wc)[:, :hc]
        dms = torch.where(torch.isfinite(dms), dms, torch.zeros_like(dms))
        dms = fill_in_multiscale(dms, lite=depth_fill_lite)

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

    def __init__(self, cfg: MMRIEncoderConfig, i2p_views: int = 0, i2p_sample: str = "bilinear",
                 i2p_dedupe: int = 0, i2p_dtype: str = "float32"):
        super().__init__()
        c, k = cfg.hidden_channel, cfg.local_attn_kernel
        self.i2p = MMRI_I2P(c, i2p_views, i2p_sample, i2p_dedupe, i2p_dtype)
        self.p_iml = LocalContextAttentionBlock(c, c, c, k)
        self.p_out_proj = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.p_integration = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.p2i_local = LocalContextAttentionBlock(c, c, c, k)
        self.i_iml = LocalContextAttentionBlock(c, c, c, k)
        self.i_out_proj = ConvBNReLU(2 * c, c, 1, use_act=False)
        self.i_integration = ConvBNReLU(2 * c, c, 1, use_act=False)

    def forward(self, img_feat, lidar_feat, batch, warp_grid, i2p_geom, train: bool = False, bf16: bool = False):
        b, v = img_feat.shape[:2]
        with span("di.mmri.i2p"):
            i2p = self.i2p(lidar_feat, img_feat, batch["pillar_coords"], batch["pillar_valid"], i2p_geom, train)
        p2p = self.p_iml(lidar_feat, lidar_feat, train, bf16)
        p_aug = self.p_out_proj(torch.cat([i2p, p2p], -1), train)
        new_lidar = self.p_integration(torch.cat([p_aug, lidar_feat], -1), train)

        flat = img_feat.reshape(b * v, *img_feat.shape[2:])
        with span("di.mmri.p2i"):
            warped = bev_warp(lidar_feat, warp_grid)
            p2i = self.p2i_local(flat, warped.reshape(b * v, *warped.shape[2:]), train, bf16)
        i2i = self.i_iml(flat, flat, train, bf16)
        i_aug = self.i_out_proj(torch.cat([p2i, i2i], -1), train)
        new_img = self.i_integration(torch.cat([i_aug, flat], -1), train)
        return new_img.reshape(b, v, *new_img.shape[1:]), new_lidar


class MMRIEncoder(nn.Module):
    """Shared 3x3 convs to the hidden width, then ``num_layers`` interaction
    layers. Returns (new_img [B, V, h, w, C], (pts_feat_conv, new_pts)).

    The JAX package's settings (``levers.py``) come in as arguments, each
    0 or off by default (the reference's math): ``i2p_views``,
    ``i2p_sample``, ``i2p_dedupe`` and ``i2p_dtype`` for :class:`MMRI_I2P`
    and its geometry, ``warp_views`` and ``depth_fill_lite`` (eval only) for
    :func:`bevwarp_grid`. ``bf16`` (a forward argument) runs the local
    attentions on K2's bf16 variant."""

    def __init__(self, cfg: MMRIEncoderConfig, cin_img: int, cin_pts: int,
                 pc_range: Tuple[float, ...], input_shape: Tuple[int, int], i2p_views: int = 0,
                 i2p_sample: str = "bilinear", i2p_dedupe: int = 0, warp_views: int = 0,
                 depth_fill_lite: bool = False, i2p_dtype: str = "float32"):
        super().__init__()
        c = cfg.hidden_channel
        self.pc_range = tuple(pc_range)
        self.input_shape = tuple(input_shape)
        self.num_layers = cfg.num_layers
        self.i2p_views, self.warp_views, self.depth_fill_lite = i2p_views, warp_views, depth_fill_lite
        self.shared_conv_img = Conv2d(cin_img, c, 3, 1, 1)
        self.shared_conv_pts = Conv2d(cin_pts, c, 3, 1, 1)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", MMRIEncoderLayer(cfg, i2p_views, i2p_sample, i2p_dedupe, i2p_dtype))

    def forward(self, img_feats, pts_feats, batch: Dict[str, torch.Tensor], train: bool = False,
                bf16: bool = False):
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
                self.pc_range, self.warp_views, self.depth_fill_lite and not train,
            )
            geom = i2p_geometry(
                batch["pillars"], batch["pillar_counts"], batch["lidar2img"],
                batch["lidar_aug_inv"], self.input_shape, self.i2p_views,
            )
        for i in range(self.num_layers):
            img, pts = getattr(self, f"layer{i}")(img, pts, batch, warp_grid, geom, train, bf16)
        return img, (pts_feat_conv, pts)
