from xf_flash_attention_cutlass_tpu_torch.utils.platform import (  # noqa: F401
    cdiv,
    is_cuda,
    next_multiple,
    resolve_device,
)
