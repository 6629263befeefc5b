"""Multi-device on `torch.distributed`: the twin of `gat_tpu/parallel/`,
one process per device (`launch.py`), a (data, model) DeviceMesh
(`mesh.py`), data-parallel inference and training and the MLP's tensor
parallelism (`sharded.py`), time-sharded onsets (`timeshard.py`) and a
GPipe demonstration (`pipeline.py`)."""
from .mesh import (make_mesh, data_sharding, replicated,  # noqa: F401
                   shard_batch, pad_to_multiple, DATA, MODEL)
from .sharded import (make_sharded_transcribe,  # noqa: F401
                      make_sharded_transcribe_files,
                      make_sharded_train_step, mlp_tp_shardings,
                      sharded_batch_pitch)
