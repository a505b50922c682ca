"""Image-point fusion of GraphRCNN's camera branch (counterpart of
``tmae_tpu/models/point_sample.py``; the reference's ``pcdet/models/
fusion_layers/point_sample.py`` and ``utils/transform_utils.py``): undo
the world augmentation of each sample's points (its ``aug_inverse``),
project them into the camera image, carry the pixel into the processed
image, and sample the image features there bilinearly (kernel
``POINT_SAMPLE`` on the card, its gradient to the features
``BILINEAR_GRAD``).

F16 (ROADMAP.md, found in the reference): the calibration projects into
the raw camera image, while the features are of the image after
``imrescale`` (and ``imflip``) and before ``impad``. The JAX package
divides the raw pixel by the feature stride alone and tests it against the
padded batch shape. Here the pixel is first scaled by the sample's
``image_scale`` (w, h), mirrored where ``image_flip`` (pixel centres at
integers: u -> w - 1 - u), and tested against ``image_shape`` (h, w), the
processed image before padding. With a scale of 1, no flip and the padded
shape, this is the JAX package's computation.
"""

from __future__ import annotations

import torch

from ..ops.dcn import sample_points


def points_lidar2img(points, proj_mat):
    """points [..., N, 3], proj [..., 3|4, 4] → pixel coordinates
    [..., N, 2] (x, y) and depth [..., N] (``transform_utils.
    points_lidar2img``; the depth divisor clipped at 1e-5)."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    cam = hom @ proj_mat[..., :3, :].transpose(-1, -2)
    depth = cam[..., 2:3].clamp(min=1e-5)
    return cam[..., :2] / depth, cam[..., 2]


class PointSample:
    """The fusion op: for each sample, undo the world augmentation, project,
    carry into the processed image (F16), divide by the feature stride and
    sample."""

    def __call__(self, points, img_feats, trans_lidar_to_cam,
                 trans_cam_to_img, image_shape, image_scale,
                 feat_stride: int = 4, aug_inverse=None, image_flip=None):
        """points [B, N, 3]; img_feats [B, Hf, Wf, C]; trans_* [B, 4, 4] /
        [B, 3, 4]; image_shape [B, 2] (h, w) and image_scale [B, 2] (w, h)
        of the processed image; aug_inverse [B, 4, 4] and image_flip [B]
        or None → features [B, N, C], in-image mask [B, N]."""
        if aug_inverse is not None:
            hom = torch.cat([points, torch.ones_like(points[..., :1])], -1)
            points = (hom @ aug_inverse.transpose(-1, -2))[..., :3]
        proj = trans_cam_to_img[:, :3] @ trans_lidar_to_cam
        uv, depth = points_lidar2img(points, proj)
        uv = uv * image_scale[:, None, :].to(uv.dtype)
        h = image_shape[:, 0, None].to(uv.dtype)
        w = image_shape[:, 1, None].to(uv.dtype)
        u, v = uv[..., 0], uv[..., 1]
        if image_flip is not None:
            u = torch.where(image_flip[:, None], w - 1 - u, u)
        in_img = ((u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
                  & (depth > 0))
        feats = sample_points(img_feats, v / feat_stride, u / feat_stride,
                              in_img)
        return feats, in_img


point_sample = PointSample()
