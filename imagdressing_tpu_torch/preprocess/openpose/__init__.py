from imagdressing_tpu_torch.preprocess.openpose.infer import OpenPose  # noqa: F401
from imagdressing_tpu_torch.preprocess.openpose.draw import draw_bodypose  # noqa: F401
