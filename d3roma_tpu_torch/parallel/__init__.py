"""Data and tensor parallelism of the port on torch.distributed.

Port of `d3roma_tpu/parallel/` (`mesh.py`, `tensor.py`). Not here yet
(ROADMAP.md §1 item 10): the spatial axis (`spatial.py`: `SEQ_AXIS`,
`make_mesh_dp_sp`, ...) and `shard_state_tp` (tensor-parallel training).
JAX's `batch_sharding`, `replicate_sharding` and `tp_param_shardings`
describe NamedShardings, which PyTorch has no counterpart of: a rank holds
its rows (`shard_batch`) and its shards (`shard_params_tp`) itself.
"""

from d3roma_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    all_reduce,
    broadcast_object,
    data_rows,
    init_distributed,
    make_mesh,
    pad_batch_to_devices,
    randn_rows,
    replicate_state,
    shard_batch,
    slice_process_local,
)
from d3roma_tpu_torch.parallel.tensor import (  # noqa: F401
    MODEL_AXIS,
    TPShard,
    make_mesh_dp_tp,
    param_bytes,
    shard_params_tp,
    shard_pipeline_tp,
    tp_param_specs,
    tp_shard_count,
)
