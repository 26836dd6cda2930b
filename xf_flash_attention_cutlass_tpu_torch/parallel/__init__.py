"""The parallel layers on ``torch.distributed``: the dp x tp mesh
(``mesh.py``), tensor- and data-parallel training (``tp.py``) and serving
(``tp_serve.py``; the engine's ``mesh=`` mode). Expert, pipeline and
sequence parallelism (the JAX package's ``ep.py``, ``ep_serve.py``,
``pp.py``, ``pp_serve.py``, ``ring.py`` and ``ulysses.py``) are not ported
yet."""

from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import (  # noqa: F401
    param_partition_specs,
    replica_rows,
    shard_params,
    tp_forward,
    tp_loss_and_grad,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import (  # noqa: F401
    gather_rows,
    pool_partition_specs,
    shard_pools,
    tp_decode_multi_step,
    tp_decode_step,
    tp_dp_decode_step,
    tp_prefill_chunk_step,
    tp_verify_step,
)
