"""SSD3D's vote head (counterpart of ``tmae_tpu/models/point_head_vote.py``):
seeds are a static slice of the backbone's points; each votes an offset
(clipped per axis); the votes' features are aggregated by a set-abstraction
layer at the vote positions; three FC stacks give the class and box
predictions. Targets and the loss's terms (seed regression, vote
classification with centerness, vote regression with heading bins, the
corner loss) are computed with masks, as the JAX package computes them.

The loss's normalisers (counts of foreground votes and seeds) are summed
over the ranks under data parallelism (``parallel/dist.global_sum``), so
each rank's loss is its share of the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import PointBinResidualCoder
from ..ops.losses import boxes_to_corners_3d, weighted_smooth_l1
from ..ops.roi_pool import points_in_boxes
from ..parallel.dist import global_sum
from .layers import LinearBNReLU
from .pointnet2_backbone import SetAbstractionFSMSG


def enlarge_box3d(boxes, extra_width):
    """boxes [..., 7+] with (ex, ey, ez) added to the sizes."""
    ex = torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([boxes[..., :3], boxes[..., 3:6] + ex, boxes[..., 6:]],
                     -1)


def generate_centerness_mask(pts, boxes):
    """The cube root of a point's centerness in its box: pts [..., 3],
    boxes [..., 7] → [...]."""
    off = pts - boxes[..., 0:3]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    u = off[..., 0] * c + off[..., 1] * s
    v = -off[..., 0] * s + off[..., 1] * c
    canon = torch.stack([u, v, off[..., 2]], -1)
    half = boxes[..., 3:6] / 2
    dist_min = torch.minimum(half - canon, half + canon)
    dist_max = torch.maximum(half - canon, half + canon)
    ctr = dist_min / dist_max.clamp(min=1e-6)
    ctr = ctr[..., 0] * ctr[..., 1] * ctr[..., 2]
    return torch.pow(ctr.clamp(min=1e-6), 1.0 / 3)


def _first_box_labels(pts, pmask, gt_boxes, gt_mask):
    """The first gt box holding each point: (index [B, N] or -1, that box
    [B, N, 8], box 0's for none)."""
    idx = torch.where(pmask, points_in_boxes(pts, gt_boxes, gt_mask), -1)
    box = torch.gather(gt_boxes, 1, idx.clamp(min=0).long()[..., None]
                       .expand(-1, -1, gt_boxes.shape[-1]))
    return idx, box


def point_coder(model_cfg) -> PointBinResidualCoder:
    return PointBinResidualCoder(
        **dict(model_cfg['TARGET_CONFIG']['BOX_CODER_CONFIG']))


class PointHeadVote(nn.Module):
    """Vote generation, vote feature aggregation and the class / box
    predictions. ``cin``: the backbone's feature channels."""

    def __init__(self, model_cfg, num_class: int, cin: int):
        super().__init__()
        self.model_cfg = model_cfg
        vc = model_cfg['VOTE_CONFIG']
        self.seed_range = [int(v) for v in vc['SAMPLE_RANGE']]
        self.register_buffer('vote_range', torch.tensor(
            [float(v) for v in vc['VOTE_XYZ_RANGE']]), persistent=False)
        c = cin
        self.n_vote = len(vc['MLPS'])
        for wi, w in enumerate(vc['MLPS']):
            self.add_module(f'vote_mlp{wi}', LinearBNReLU(c, int(w)))
            c = int(w)
        self.vote_out = nn.Linear(c, 3)
        sa = model_cfg['VOTE_SA_CONFIG']
        self.vote_sa = SetAbstractionFSMSG(cin, sa['RADIUS'], sa['NSAMPLE'],
                                           sa['MLPS'])
        self.stacks = {}
        c = self.vote_sa.out_channels
        for stack in ('shared_fc', 'cls_fc', 'reg_fc'):
            cs = c if stack == 'shared_fc' else self.stacks['shared_fc'][1]
            widths = [int(w) for w in model_cfg.get(stack.upper(), [])]
            for wi, w in enumerate(widths):
                self.add_module(f'{stack}{wi}', LinearBNReLU(cs, w))
                cs = w
            self.stacks[stack] = (len(widths), cs)
        self.cls_out = nn.Linear(self.stacks['cls_fc'][1], num_class)
        self.box_out = nn.Linear(self.stacks['reg_fc'][1],
                                 point_coder(model_cfg).code_size)

    def _stack(self, name, x, mask):
        for wi in range(self.stacks[name][0]):
            x = getattr(self, f'{name}{wi}')(x, mask)
        return x

    def forward(self, point_coords, point_mask, point_features):
        """point_coords [B, N, 3], point_features [B, N, C] → seeds, votes
        [B, K, 3], vote mask [B, K], class and box predictions [B, K, .]."""
        r0, r1 = self.seed_range
        seeds = point_coords[:, r0:r1]
        seed_mask = point_mask[:, r0:r1]
        x = point_features[:, r0:r1]
        for wi in range(self.n_vote):
            x = getattr(self, f'vote_mlp{wi}')(x, seed_mask)
        rng = self.vote_range
        votes = seeds + torch.clamp(self.vote_out(x), -rng, rng)
        _, _, x, _ = self.vote_sa(point_coords, point_mask, point_features,
                                  new_xyz=votes, new_mask=seed_mask)
        x = self._stack('shared_fc', x, seed_mask)
        cls_preds = self.cls_out(self._stack('cls_fc', x, seed_mask))
        box_preds = self.box_out(self._stack('reg_fc', x, seed_mask))
        return {'seeds': seeds, 'votes': votes, 'vote_mask': seed_mask,
                'vote_cls_preds': cls_preds, 'vote_box_preds': box_preds}


def point_head_vote_targets(out, gt_boxes, gt_mask, coder, model_cfg,
                            num_class):
    """Targets of the votes (the first gt box holding the vote, foreground
    within ``GT_CENTRAL_RADIUS`` of its centre, ignored beyond) and of the
    seeds (inside the gt boxes grown by ``GT_EXTRA_WIDTH``). The vote box
    labels are encoded at the votes and keep their gradient."""
    tc = model_cfg['TARGET_CONFIG']
    votes, vmask, seeds = out['votes'], out['vote_mask'], out['seeds']
    vidx, vbox = _first_box_labels(votes, vmask, gt_boxes, gt_mask)
    radius = float(tc.get('GT_CENTRAL_RADIUS', 2.0))
    near = torch.linalg.vector_norm(vbox[..., :3] - votes, dim=-1) < radius
    fg = (vidx >= 0) & near
    ignored = (vidx >= 0) & ~near
    cls = (vbox[..., 7].int() if num_class > 1
           else torch.ones_like(vidx))
    labels = torch.where(fg, cls, torch.where(ignored, -1, 0))
    box_labels = coder.encode(vbox[..., :7], votes, vbox[..., 7].int())
    box_labels = torch.where(fg[..., None], box_labels, 0.0)
    sidx, sbox = _first_box_labels(
        seeds, vmask, enlarge_box3d(gt_boxes, tc['GT_EXTRA_WIDTH']), gt_mask)
    return {'vote_cls_labels': labels, 'vote_fg': fg,
            'vote_box_labels': box_labels, 'gt_box_of_fg_votes': vbox,
            'seed_fg': sidx >= 0, 'gt_box_of_fg_seeds': sbox}


def point_head_vote_loss(out, gt_boxes, gt_mask, coder, model_cfg,
                         num_class):
    """The vote head's loss: seed regression, vote classification (binary
    cross entropy against the one-hot class scaled by the vote's
    centerness, the votes detached there), vote regression (smooth-L1 of
    centre and sizes, heading-bin cross entropy, bin residual) and the L1
    corner loss of the decoded boxes (their gradient reaches the votes).
    The auxiliary class term is 0: the backbone gives no per-level scores.
    Returns (total, parts)."""
    lc = model_cfg['LOSS_CONFIG']
    lw = lc['LOSS_WEIGHTS']
    tgt = point_head_vote_targets(out, gt_boxes, gt_mask, coder, model_cfg,
                                  num_class)
    vmask = out['vote_mask']
    fg = tgt['vote_fg'] & vmask
    labels = tgt['vote_cls_labels']
    count = lambda m: global_sum(m.sum().float()).clamp(min=1.0)

    sfg = tgt['seed_fg'] & vmask
    seed_l = weighted_smooth_l1(out['votes'], tgt['gt_box_of_fg_seeds'][..., :3],
                                weights=sfg.float()).sum(-1)
    seed_loss = seed_l.sum() / count(sfg) * float(lw['seed_reg_weight_list'][0])

    pos = (labels > 0) & vmask
    neg = (labels == 0) & vmask
    cls_w = (pos | neg).float()
    norm = count(pos) if lc.get('CLS_POS_NORM', True) else count(cls_w)
    cls_w = cls_w / norm
    one_hot = F.one_hot(labels.clamp(min=0).long(), num_class + 1)[..., 1:]
    one_hot = one_hot.float()
    if 'WithCenterness' in lc.get('CLS_LOSS', ''):
        ctr = generate_centerness_mask(out['votes'].detach(),
                                       tgt['gt_box_of_fg_votes'])
        one_hot = one_hot * torch.where(pos, ctr, 0.0)[..., None]
    logits = out['vote_cls_preds']
    bce = (logits.clamp(min=0) - logits * one_hot
           + torch.log1p(torch.exp(-logits.abs())))
    cls_loss = (bce.mean(-1) * cls_w).sum() * float(lw['vote_cls_weight'])

    reg_w = fg.float() / count(fg)
    preds, labs = out['vote_box_preds'], tgt['vote_box_labels']
    n = coder.angle_bin_num
    loss_xyzlwh = weighted_smooth_l1(preds[..., :6], labs[..., :6],
                                     weights=reg_w).sum()
    dir_onehot = labs[..., 6:6 + n]
    dir_ce = -(F.log_softmax(preds[..., 6:6 + n], -1) * dir_onehot).sum(-1)
    loss_dir_cls = (dir_ce * reg_w).sum()
    res_pred = (preds[..., 6 + n:6 + 2 * n] * dir_onehot).sum(-1)
    res_lab = (labs[..., 6 + n:6 + 2 * n] * dir_onehot).sum(-1)
    loss_dir_res = weighted_smooth_l1(res_pred[..., None], res_lab[..., None],
                                      weights=reg_w).sum()
    reg_loss = (loss_xyzlwh + loss_dir_cls + loss_dir_res) * float(
        lw['vote_reg_weight'])

    gt_votes = tgt['gt_box_of_fg_votes']
    decoded = coder.decode(preds, out['votes'], gt_votes[..., 7].int())
    corner = (boxes_to_corners_3d(decoded[..., :7])
              - boxes_to_corners_3d(gt_votes[..., :7])).abs().sum(-1).mean(-1)
    corner_loss = (corner * fg).sum() / count(fg) * float(
        lw['vote_corner_weight'])

    total = seed_loss + cls_loss + reg_loss + corner_loss
    return total, {'seed_reg_loss': seed_loss, 'vote_cls_loss': cls_loss,
                   'vote_reg_loss': reg_loss, 'vote_corner_loss': corner_loss}


def point_head_vote_predict(out, coder):
    """(sigmoid class scores [B, K, num_class], 0 at invalid votes; boxes
    [B, K, 7+] decoded at the votes with each vote's best class)."""
    logits = out['vote_cls_preds']
    boxes = coder.decode(out['vote_box_preds'], out['votes'],
                         logits.argmax(-1) + 1)
    scores = torch.where(out['vote_mask'][..., None], torch.sigmoid(logits),
                         0.0)
    return scores, boxes
