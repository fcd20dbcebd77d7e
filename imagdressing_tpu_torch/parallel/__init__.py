"""Parallelism toolkit: the (data, model) layout of ranks and its
collectives, the tensor-parallel rules, the multi-device training steps,
and `launch` (port of `imagdressing_tpu/parallel/__init__.py`: one import
point over `core/mesh.py`, `core/tp.py` and `train/step.py`)."""

from imagdressing_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather,
    init_from_env,
    make_mesh,
    pmean,
    psum,
    reduce_scatter,
)
from imagdressing_tpu_torch.core.tp import split_models, tp_kind  # noqa: F401
from imagdressing_tpu_torch.train.step import (  # noqa: F401
    shard_train_step,
    tp_train_step,
)
