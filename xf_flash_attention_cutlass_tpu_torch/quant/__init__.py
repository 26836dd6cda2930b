from xf_flash_attention_cutlass_tpu_torch.quant.kv import (  # noqa: F401
    KV_QUANT_DTYPES,
    dequantize_kv,
    quantize_kv,
    quantize_kv_pools,
)
from xf_flash_attention_cutlass_tpu_torch.quant.linear import (  # noqa: F401
    QuantizedLinear,
    quantize_weight,
    quantized_matmul,
)
