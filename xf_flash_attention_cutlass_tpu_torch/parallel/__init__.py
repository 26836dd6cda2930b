"""The parallel layers on ``torch.distributed``: the device mesh
(``mesh.py``), tensor- and data-parallel training (``tp.py``) and serving
(``tp_serve.py``; the engine's ``mesh=`` mode), expert parallelism for the
MoE family, training (``ep.py``) and serving (``ep_serve.py``),
pipeline parallelism, training (``pp.py``: GPipe microbatches, the
backward pipeline written out) and serving (``pp_serve.py``:
``pp_decode_step``, which the engine does not call, as in the JAX package),
and sequence parallelism over the mesh's "cp" group, differentiable: the
ring and the balanced zigzag ring (``ring.py``, on K7 and K9/K10 at every
hop) and all-to-all Ulysses (``ulysses.py``), which the engine does not
serve, as in the JAX package."""

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
from xf_flash_attention_cutlass_tpu_torch.parallel.ep import (  # noqa: F401
    moe_ep_forward,
    moe_ep_loss_and_grad,
    shard_moe_params,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.ep_serve import (  # noqa: F401
    ep_decode_step,
    ep_prefill_chunk_step,
    shard_ep,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.pp import (  # noqa: F401
    pp_forward,
    pp_loss_and_grad,
    pp_param_partition_specs,
    shard_pp_params,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.pp_serve import (  # noqa: F401
    pp_decode_step,
    pp_pool_specs,
    shard_pp_pools,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    ring_attention_zigzag,
    zigzag_permute,
    zigzag_unpermute,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
