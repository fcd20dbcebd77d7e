"""Person instance segmentation (Mask R-CNN) of the offline dataset
toolchain (port of `imagdressing_tpu/detect/`; the reference's vendored
detectron2 mhp_extension detector, tools/finetune_net.py +
configs/Misc/parsing_finetune_cihp.yaml)."""

from imagdressing_tpu_torch.detect.maskrcnn import (  # noqa: F401
    MaskRCNNConfig,
    apply_backbone_fpn,
    generate_anchors,
    init,
)
