from xf_flash_attention_cutlass_tpu_torch.ops.reference import (  # noqa: F401
    attention_ref,
    attn_bias_from_alibi_slopes,
    construct_local_mask,
)
