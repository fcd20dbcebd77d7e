"""Post-processing of decoded images on the host (port of
`imagdressing_tpu/postprocess/`): the seat of the reference's face-fusion
step."""

from imagdressing_tpu_torch.postprocess.face_fusion import (  # noqa: F401
    FaceFusion,
    fuse_face,
    make_post_process,
    umeyama,
)
