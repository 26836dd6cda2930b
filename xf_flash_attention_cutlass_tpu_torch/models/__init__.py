from xf_flash_attention_cutlass_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    forward,
    init_params,
    quantize_params,
)
