"""Attention ops of the port: each kernel's wrapper beside its plain version."""

from .attention import (  # noqa: F401
    flash_attention,
    flash_dkv,
    flash_dq,
    reference_attention,
    reference_flash_bwd,
    reference_flash_dkv,
    reference_flash_dq,
    reference_flash_fwd,
)
from .decode_attention import (  # noqa: F401
    decode_attention,
    reference_decode_attention,
    write_token_to_cache,
)
