"""MMPI decoder head (port of ``deepinteraction_tpu/models/decoder.py``):
heatmap-initialised queries, a transformer layer against the BEV tokens,
then alternating image / LiDAR predictive-interaction blocks. In LiDAR-only
mode (TransFusion-L) there is one heatmap head and no MMPI block: the
initial layer is the output.

The DeepInteraction++ variant (``cfg.variant == "pp"``) swaps the blocks'
trunk for the dual-branch ``RCNNCoreV2``, feeds the prediction heads the
cross feature only (``c`` wide, not ``2c``), moves the query centres by the
look-forward update, and keeps one cumulative on-image mask per MMPI layer
(odd layers inherit the last one), with which every layer falls back to
the initial predictions.

- ``train=True`` normalises with batch statistics and applies the
  attention dropout of the JAX ``TransformerDecoderLayer`` and of the MMPI
  blocks' self-attention, with masks from the caller's generator. The
  proposal heatmap, the query positions and the boxes the MMPI blocks
  decode (so their ROIs and image projections) carry no gradient, where
  JAX stops it.

- Proposal top-k is a stable descending sort: on ties the smallest index
  wins, as ``jax.lax.top_k`` does (``torch.topk`` does not promise it).
- The image block keeps the reference's "last view wins": each query is
  refined only against the highest-index view it lands on.
- Per-class local-max NMS on the heatmap, k=1 for classes 8 and 9.
- LayerNorms are torch's (eps 1e-5, two-pass variance), which the JAX
  ``TorchLayerNorm`` pins.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import BBoxCoderConfig, DecoderConfig

from ..ops.roi_align import roi_align, roi_align_views
from ..targets.coder import TransFusionBBoxCoder
from ..utils.boxes import corners as box_corners
from ..utils.geometry import transform_points
from ..utils.spans import span
from .layers import BatchNorm, ConvBNReLU, Conv2d, MLP1d, TorchMHA


class PositionEmbeddingLearned(nn.Module):
    """Dense(2->C) + BN + ReLU + Dense(C->C)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc0 = nn.Linear(2, c)
        self.bn0 = BatchNorm(c)
        self.fc1 = nn.Linear(c, c)

    def forward(self, xy, train: bool = False):
        return self.fc1(F.relu(self.bn0(self.fc0(xy), train)))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, c: int, nhead: int, dim_ff: int, dropout: float = 0.0):
        super().__init__()
        self.self_posembed = PositionEmbeddingLearned(c)
        self.cross_posembed = PositionEmbeddingLearned(c)
        self.self_attn = TorchMHA(c, nhead, dropout)
        self.cross_attn = TorchMHA(c, nhead, dropout)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(c), nn.LayerNorm(c), nn.LayerNorm(c)
        self.linear1 = nn.Linear(c, dim_ff)
        self.linear2 = nn.Linear(dim_ff, c)

    def forward(self, query, key, query_pos, key_pos, train: bool = False, generator=None):
        qe = self.self_posembed(query_pos, train)
        ke = self.cross_posembed(key_pos, train)
        q = query + qe
        query = self.norm1(query + self.self_attn(q, q, q, train=train, generator=generator))
        y = self.cross_attn(query + qe, key + ke, key + ke, train=train, generator=generator)
        query = self.norm2(query + y)
        y = self.linear2(F.relu(self.linear1(query)))
        return self.norm3(query + y)


class PredictionFFN(nn.Module):
    def __init__(self, cin: int, heads, head_conv: int = 64):
        super().__init__()
        self.names = [name for name, _ in heads]
        for name, (classes, num_conv) in heads:
            self.add_module(name, MLP1d(cin, head_conv, classes, num_conv))

    def forward(self, x, train: bool = False) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x, train) for name in self.names}


class DynamicConv(nn.Module):
    """Query-conditioned two-step dynamic matmul over 7x7 ROI features."""

    def __init__(self, hidden: int, dyn: int, pool: int = 7):
        super().__init__()
        self.hidden, self.dyn = hidden, dyn
        self.dynamic_layer = nn.Linear(hidden, 2 * hidden * dyn)
        self.norm1, self.norm2 = nn.LayerNorm(dyn), nn.LayerNorm(hidden)
        self.out_layer = nn.Linear(pool * pool * hidden, hidden)
        self.norm3 = nn.LayerNorm(hidden)

    def forward(self, pro_features, roi_features):
        """pro_features [B, P, C]; roi_features [B, P, 49, C] -> [B, P, C]."""
        n = self.hidden * self.dyn
        params = self.dynamic_layer(pro_features)
        p1 = params[..., :n].reshape(*params.shape[:-1], self.hidden, self.dyn)
        p2 = params[..., n:].reshape(*params.shape[:-1], self.dyn, self.hidden)
        f = F.relu(self.norm1(torch.einsum("...kc,...cd->...kd", roi_features, p1)))
        f = F.relu(self.norm2(torch.einsum("...kd,...dc->...kc", f, p2)))
        f = self.out_layer(f.reshape(*f.shape[:-2], -1))
        return F.relu(self.norm3(f))


class RCNNCore(nn.Module):
    """Self-attn -> DynamicConv -> FFN (exact-erf GELU) trunk."""

    def __init__(self, c: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = TorchMHA(c, num_heads, dropout)
        self.norm1 = nn.LayerNorm(c)
        self.dyconv = DynamicConv(c, c)
        self.norm2 = nn.LayerNorm(c)
        self.linear1 = nn.Linear(c, 4 * c)
        self.linear2 = nn.Linear(4 * c, c)
        self.norm3 = nn.LayerNorm(c)

    def forward(self, query_feat, roi_feats, attn_mask=None, train: bool = False, generator=None):
        y = self.self_attn(query_feat, query_feat, query_feat, attn_mask=attn_mask, train=train,
                           generator=generator)
        q = self.norm1(query_feat + y)
        q = self.norm2(q + self.dyconv(q, roi_feats))
        y = self.linear2(F.gelu(self.linear1(q)))
        return self.norm3(q + y)


class RCNNCoreV2(nn.Module):
    """The ++ dual-branch trunk: self-attention + norm (the branch point);
    DynamicConv and an FFN on the cross branch; a separate FFN on the self
    branch; ``cross * scale + self * self_scale``.

    The reference's combine broadcasts (its self branch is still seq-first
    when added): every query receives the self-branch value of the *first*
    query of its attention group, which the caller passes as
    ``self_contrib`` [B, P or 1, C]; by default query 0's (the point
    block). Released ++ checkpoints were trained with it, so it is kept."""

    def __init__(self, c: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = TorchMHA(c, num_heads, dropout)
        self.norm1 = nn.LayerNorm(c)
        self.dyconv = DynamicConv(c, c)
        self.norm2 = nn.LayerNorm(c)
        self.norm3 = nn.LayerNorm(c)
        self.ffn_fc0 = nn.Linear(c, 4 * c)
        self.ffn_fc1 = nn.Linear(4 * c, c)
        self.self_ffn_fc0 = nn.Linear(c, 4 * c)
        self.self_ffn_fc1 = nn.Linear(4 * c, c)
        self.self_norm = nn.LayerNorm(c)
        self.scale = nn.Parameter(torch.full((1,), 0.5))
        self.self_scale = nn.Parameter(torch.full((1,), 0.5))

    def norm1_block(self, query_feat, key_mask=None, attn_mask=None, train: bool = False, generator=None):
        """Self-attention + residual + norm1 (the branch point)."""
        y = self.self_attn(query_feat, query_feat, query_feat, key_mask=key_mask, attn_mask=attn_mask,
                           train=train, generator=generator)
        return self.norm1(query_feat + y)

    def self_branch(self, q1):
        return self.self_norm(q1 + self.self_ffn_fc1(F.relu(self.self_ffn_fc0(q1))))

    def forward(self, query_feat, roi_feats, attn_mask=None, train: bool = False, generator=None,
                self_contrib=None):
        q = self.norm1_block(query_feat, attn_mask=attn_mask, train=train, generator=generator)
        if self_contrib is None:
            self_contrib = self.self_branch(q)[..., :1, :]
        q = self.norm2(q + self.dyconv(q, roi_feats))
        q = self.norm3(q + self.ffn_fc1(F.relu(self.ffn_fc0(q))))
        return q * self.scale + self_contrib * self.self_scale


def _rcnn_core(cfg: DecoderConfig) -> nn.Module:
    core = RCNNCoreV2 if cfg.variant == "pp" else RCNNCore
    return core(cfg.hidden_channel, cfg.num_heads, cfg.dropout)


class ImageRCNNBlock(nn.Module):
    """Project query boxes into every view; refine each on-image query
    against an ROI crop of the last view it lands on."""

    def __init__(self, cfg: DecoderConfig, coder: TransFusionBBoxCoder, input_shape):
        super().__init__()
        self.cfg, self.coder, self.input_shape = cfg, coder, tuple(input_shape)
        self.core = _rcnn_core(cfg)

    def forward(self, query_feat, res_layer, img_feats, batch, train: bool = False, generator=None):
        b, p, c = query_feat.shape
        v = img_feats.shape[1]
        ih, iw = self.input_shape
        ccfg = self.coder.cfg
        res_layer = {k: t.detach() for k, t in res_layer.items()}  # JAX stop_gradient
        boxes = self.coder.decode(res_layer).boxes
        qx = res_layer["center"][..., 0] * ccfg.out_size_factor * ccfg.voxel_size[0] + ccfg.pc_range[0]
        qy = res_layer["center"][..., 1] * ccfg.out_size_factor * ccfg.voxel_size[1] + ccfg.pc_range[1]
        qz = res_layer["height"][..., 0]
        centers3d = torch.stack([qx, qy, qz], -1)
        crn = box_corners(boxes[..., :7])  # [B, P, 8, 3]

        rects, on_imgs = [], []
        for i in range(b):
            pts = torch.cat([centers3d[i], crn[i].reshape(p * 8, 3)], 0)
            raw = transform_points(batch["lidar_aug_inv"][i], pts)
            hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
            cam = torch.einsum("nj,vij->vni", hom, batch["lidar2img"][i])  # [V, 9P, 4]
            z = torch.clamp(cam[..., 2], min=1e-5)
            xy = cam[..., :2] / z[..., None]
            cxy, korn = xy[:, :p], xy[:, p:].reshape(v, p, 8, 2)
            on_img = (cxy[..., 0] > 0) & (cxy[..., 0] < iw) & (cxy[..., 1] > 0) & (cxy[..., 1] < ih)
            on_img = on_img & (on_img.sum(-1, keepdim=True) > 1)  # reference skip rule
            rects.append(torch.cat([korn.amin(2), korn.amax(2)], -1))  # [V, P, 4]
            on_imgs.append(on_img)
        rect, on_img = torch.stack(rects), torch.stack(on_imgs)  # [B, V, P, 4], [B, V, P]

        view_ids = torch.arange(v, device=on_img.device)[None, :, None]
        eff = torch.where(on_img, view_ids, torch.full_like(view_ids, -1)).amax(1)  # [B, P]
        any_on = eff >= 0
        sel = eff.clamp(0, v - 1)
        rect_sel = torch.gather(rect, 1, sel[:, None, :, None].expand(b, 1, p, 4))[:, 0]
        rois = torch.stack([
            roi_align_views(img_feats[i], rect_sel[i], sel[i], output_size=7,
                            spatial_scale=1.0 / self.cfg.out_size_factor_img)
            for i in range(b)
        ]).reshape(b, p, 49, c)
        # query i attends the queries on its winning view (diagonal kept on)
        attn_mask = torch.gather(on_img, 1, sel[:, :, None].expand(b, p, p))
        attn_mask = attn_mask | torch.eye(p, dtype=torch.bool, device=on_img.device)[None]
        if self.cfg.variant == "pp":
            # the broadcast quirk (RCNNCoreV2): a query's self term is the
            # self branch of the first on-image query of its winning view,
            # computed with that view's key set
            qf_v = query_feat[:, None].expand(b, v, p, c).reshape(b * v, p, c)
            q1 = self.core.norm1_block(qf_v, key_mask=on_img.reshape(b * v, p), train=train,
                                       generator=generator)
            jstar = on_img.int().argmax(2).reshape(b * v)  # the first on-image query
            q1_star = q1[torch.arange(b * v, device=q1.device), jstar]
            s_view = self.core.self_branch(q1_star).reshape(b, v, c)
            self_contrib = torch.gather(s_view, 1, sel[..., None].expand(b, p, c))
            refined = self.core(query_feat, rois, attn_mask, train, generator, self_contrib)
        else:
            refined = self.core(query_feat, rois, attn_mask, train, generator)
        return torch.where(any_on[..., None], refined, refined.new_zeros(())), eff


class PointRCNNBlock(nn.Module):
    """ROI refinement against the fused BEV map with 2x-enlarged boxes."""

    def __init__(self, cfg: DecoderConfig, coder: TransFusionBBoxCoder):
        super().__init__()
        self.coder = coder
        self.core = _rcnn_core(cfg)

    def forward(self, query_feat, res_layer, bev_feat, train: bool = False, generator=None):
        b, p, c = query_feat.shape
        res_layer = {k: t.detach() for k, t in res_layer.items()}  # JAX stop_gradient
        boxes = self.coder.decode(res_layer).boxes[..., :7]
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6] * 2.0, boxes[..., 6:]], -1)
        crn = box_corners(boxes)[..., :2]  # [B, P, 8, 2]
        ccfg = self.coder.cfg
        scale = ccfg.voxel_size[0] * ccfg.out_size_factor
        with span("di.sync.decoder.pc_range"):
            origin = crn.new_tensor(ccfg.pc_range[:2])
        coor = (crn - origin) / scale
        rect = torch.cat([coor.amin(2), coor.amax(2)], -1)
        rois = torch.stack([
            roi_align(bev_feat[i], rect[i], output_size=7, spatial_scale=1.0) for i in range(b)
        ]).reshape(b, p, 49, c)
        return self.core(query_feat, rois, None, train, generator), None


class Decoder(nn.Module):
    """Full MMPI head (v1 or ++), or the LiDAR-only head (``cfg.lidar_only``)."""

    def __init__(self, cfg: DecoderConfig, coder_cfg: BBoxCoderConfig, input_shape):
        super().__init__()
        if cfg.variant not in ("v1", "pp"):
            raise ValueError(f"unknown decoder variant {cfg.variant!r}")
        self.cfg = cfg
        c, n_cls = cfg.hidden_channel, cfg.num_classes
        self.coder = TransFusionBBoxCoder(coder_cfg)
        self.heatmap_head_0 = ConvBNReLU(c, c, 3)
        self.heatmap_head_1 = Conv2d(c, n_cls, 3, 1, 1)
        if not cfg.lidar_only:
            self.heatmap_head_img_0 = ConvBNReLU(c, c, 3)
            self.heatmap_head_img_1 = Conv2d(c, n_cls, 3, 1, 1)
        self.class_encoding = nn.Linear(n_cls, c)
        self.decoder0 = TransformerDecoderLayer(c, cfg.num_heads, cfg.ffn_channel, cfg.dropout)
        heads = tuple(cfg.common_heads) + (("heatmap", (n_cls, cfg.num_heatmap_convs)),)
        self.pred0 = PredictionFFN(c, heads)
        for i in range(cfg.num_mmpi):
            if i % 2 == 0:
                self.add_module(f"mmpi{i}_img", ImageRCNNBlock(cfg, self.coder, input_shape))
            else:
                self.add_module(f"mmpi{i}_pts", PointRCNNBlock(cfg, self.coder))
            # v1's heads take concat(cross, prev); ++'s the cross feature only
            self.add_module(f"mmpi{i}_pred", PredictionFFN(c if cfg.variant == "pp" else 2 * c, heads))

    def forward(self, pts_inputs: Tuple[torch.Tensor, torch.Tensor], img_feats, batch,
                num_proposals: int | None = None, train: bool = False,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        p = num_proposals or cfg.num_proposals
        lidar_feat, new_lidar_feat = pts_inputs
        b, hb, wb, c = lidar_feat.shape
        n_cls = cfg.num_classes

        dense_heatmap = self.heatmap_head_1(self.heatmap_head_0(lidar_feat, train))
        if cfg.lidar_only:
            dense_heatmap_img = dense_heatmap
            heatmap = torch.sigmoid(dense_heatmap).detach()
        else:
            dense_heatmap_img = self.heatmap_head_img_1(self.heatmap_head_img_0(new_lidar_feat, train))
            heatmap = ((torch.sigmoid(dense_heatmap) + torch.sigmoid(dense_heatmap_img)) / 2.0).detach()

        # local-max NMS: 3x3 in the interior, the border zeroed; k=1 for
        # pedestrian (8) and traffic cone (9)
        hm = heatmap.permute(0, 3, 1, 2)  # [B, cls, H, W]
        pad = cfg.nms_kernel_size // 2
        inner = F.max_pool2d(hm, cfg.nms_kernel_size, stride=1, padding=0)
        local_max = torch.zeros_like(hm)
        local_max[:, :, pad:-pad, pad:-pad] = inner
        if n_cls == 10:
            local_max[:, 8] = hm[:, 8]
            local_max[:, 9] = hm[:, 9]
        hm = hm * (hm == local_max)
        hm_flat = hm.reshape(b, n_cls * hb * wb)
        top_idx = torch.sort(hm_flat, dim=1, descending=True, stable=True).indices[:, :p]
        top_cls = torch.div(top_idx, hb * wb, rounding_mode="floor").int()
        top_pos = top_idx % (hb * wb)

        lidar_flat = lidar_feat.reshape(b, hb * wb, c)
        query_feat = torch.gather(lidar_flat, 1, top_pos[..., None].expand(b, p, c))
        one_hot = F.one_hot(top_cls.long(), n_cls).to(query_feat.dtype)
        query_feat = query_feat + self.class_encoding(one_hot)

        dt, dev = lidar_feat.dtype, lidar_feat.device
        ys = torch.div(top_pos, wb, rounding_mode="floor").to(dt) + 0.5
        xs = (top_pos % wb).to(dt) + 0.5
        query_pos = torch.stack([xs, ys], -1)
        rows = torch.arange(hb, dtype=dt, device=dev) + 0.5
        cols = torch.arange(wb, dtype=dt, device=dev) + 0.5
        gy, gx = torch.meshgrid(rows, cols, indexing="ij")
        bev_pos = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)[None].expand(b, hb * wb, 2)

        query_feat = self.decoder0(query_feat, lidar_flat, query_pos, bev_pos, train, generator)
        res_layer = self.pred0(query_feat, train)
        res_layer["center"] = res_layer["center"] + query_pos
        first_res_layer = res_layer

        ret_dicts: List[Dict[str, torch.Tensor]] = []
        on_image_masks: List[torch.Tensor] = []
        pp = cfg.variant == "pp"
        query_pos_look_forward = res_layer["center"].detach()
        for i in range(cfg.num_mmpi):
            prev_query_feat = query_feat
            query_pos = res_layer["center"].detach()
            if i % 2 == 0:
                query_feat, eff_view = getattr(self, f"mmpi{i}_img")(
                    prev_query_feat, res_layer, img_feats, batch, train, generator
                )
            else:
                query_feat, eff_view = getattr(self, f"mmpi{i}_pts")(
                    prev_query_feat, res_layer, new_lidar_feat, train, generator
                )
            pred_in = query_feat if pp else torch.cat([query_feat, prev_query_feat], -1)
            res_layer = getattr(self, f"mmpi{i}_pred")(pred_in, train)
            if pp:
                # look-forward centre update; the delta keeps its gradient
                pred_delta = res_layer["center"]
                res_layer["center"] = pred_delta + query_pos_look_forward
                query_pos_look_forward = pred_delta + query_pos
            else:
                res_layer["center"] = res_layer["center"] + query_pos
            if pp or i % 2 == 0:
                if i % 2 == 1:  # ++: a point layer inherits the last mask
                    on_img = on_image_masks[-1]
                else:
                    on_img = eff_view >= 0
                    if pp and on_image_masks:  # ++: cumulative
                        on_img = on_img & on_image_masks[-1]
                on_image_masks.append(on_img)
                # off-image queries fall back to the initial predictions
                res_layer = {
                    k: torch.where(on_img[..., None], t, first_res_layer[k])
                    for k, t in res_layer.items()
                }
            ret_dicts.append(res_layer)

        query_heatmap_score = torch.gather(
            heatmap.reshape(b, hb * wb, n_cls), 1, top_pos[..., None].expand(b, p, n_cls)
        )
        if not ret_dicts:
            ret_dicts = [first_res_layer]
        out = {k: torch.cat([rd[k] for rd in ret_dicts], 1) for k in ret_dicts[0]}
        out["dense_heatmap"] = dense_heatmap_img
        out["query_heatmap_score"] = query_heatmap_score
        out["query_labels"] = top_cls
        out["on_image_masks"] = (
            torch.stack(on_image_masks)
            if on_image_masks
            else torch.ones((0, b, p), dtype=torch.bool, device=dev)
        )
        return out
