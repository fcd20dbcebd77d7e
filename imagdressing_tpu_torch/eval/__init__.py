"""CAMI-U / CAMI-S try-on metrics and the CLIP scorer (port of
`imagdressing_tpu/eval`)."""

from imagdressing_tpu_torch.eval.cami import (  # noqa: F401
    cami_u,
    harris_keypoints,
    keypoint_matching,
    lbp_histogram_correlation,
    pose_overlap,
    ssim,
)
