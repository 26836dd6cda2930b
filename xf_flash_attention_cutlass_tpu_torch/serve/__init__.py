from xf_flash_attention_cutlass_tpu_torch.serve.allocator import PagePool  # noqa: F401
from xf_flash_attention_cutlass_tpu_torch.serve.checkpoint import (  # noqa: F401
    load_engine,
    save_engine,
)
from xf_flash_attention_cutlass_tpu_torch.serve.engine import (  # noqa: F401
    DecodeEngine,
    EngineConfig,
)
