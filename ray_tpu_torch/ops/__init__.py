"""Attention ops of the port: each kernel's wrapper beside its plain version."""

from .attention import flash_attention, reference_attention  # noqa: F401
from .decode_attention import (  # noqa: F401
    decode_attention,
    reference_decode_attention,
    write_token_to_cache,
)
