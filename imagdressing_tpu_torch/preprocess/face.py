"""Face identity extraction for the ipa_pose preset (port of
`imagdressing_tpu/preprocess/face.py`).

The reference uses insightface FaceAnalysis(buffalo_l) for detection, a
512-d normed embedding and the norm_crop 224 alignment. insightface
(onnxruntime) is an optional dependency: this module delegates to it when
it is installed, and otherwise asks for precomputed inputs.
"""

from __future__ import annotations

import numpy as np

from imagdressing_tpu_torch.apps.image_utils import read_image
from imagdressing_tpu_torch.train.data import clip_preprocess_np


def face_embeds_from_image(path: str):
    """-> (faceid_embeds (1,512), face_clip_image (1,224,224,3)).

    Requires insightface. Install it (plus its onnx models) or precompute the
    embedding offline and call the pipeline with faceid_embeds= /
    face_clip_image= directly.
    """
    try:
        from insightface.app import FaceAnalysis
        from insightface.utils import face_align
    except ImportError as e:
        raise ImportError(
            "insightface is required for automatic face embedding; pass "
            "faceid_embeds/face_clip_image to the pipeline instead"
        ) from e

    app = FaceAnalysis(name="buffalo_l",
                       providers=["CPUExecutionProvider"])
    app.prepare(ctx_id=0, det_size=(640, 640))
    # insightface takes BGR, as cv2.imread gives it
    image = np.ascontiguousarray(read_image(path)[:, :, ::-1])
    faces = app.get(image)
    if not faces:
        raise ValueError(f"no face detected in {path}")
    faceid = faces[0].normed_embedding[None].astype(np.float32)
    crop = face_align.norm_crop(image, landmark=faces[0].kps, image_size=224)
    crop_rgb = crop[:, :, ::-1]
    face_clip = clip_preprocess_np(np.ascontiguousarray(crop_rgb))[None]
    return faceid, face_clip
