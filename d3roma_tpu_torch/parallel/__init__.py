"""Data and tensor parallelism of the port on torch.distributed.

Port of `d3roma_tpu/parallel/` (`mesh.py`, `tensor.py`), with the
collectives that carry training's gradients (`gather_along`, `sum_along`,
`copy_along`, `mean_gradients`) and `shard_state_tp` / `gather_params_tp`.
Not here yet (ROADMAP.md §1 item 10): the spatial axis (`spatial.py`:
`SEQ_AXIS`, `make_mesh_dp_sp`, ...).
JAX's `batch_sharding`, `replicate_sharding` and `tp_param_shardings`
describe NamedShardings, which PyTorch has no counterpart of: a rank holds
its rows (`shard_batch`) and its shards (`shard_params_tp`) itself.
"""

from d3roma_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    all_reduce,
    barrier,
    broadcast_object,
    copy_along,
    data_rows,
    gather_along,
    init_distributed,
    make_mesh,
    mean_gradients,
    pad_batch_to_devices,
    randn_rows,
    replicate_state,
    shard_batch,
    slice_process_local,
    sum_along,
)
from d3roma_tpu_torch.parallel.tensor import (  # noqa: F401
    MODEL_AXIS,
    TPShard,
    gather_params_tp,
    layer_shards,
    make_mesh_dp_tp,
    param_bytes,
    shard_params_tp,
    shard_pipeline_tp,
    shard_state_tp,
    tp_param_specs,
    tp_shard_count,
)
