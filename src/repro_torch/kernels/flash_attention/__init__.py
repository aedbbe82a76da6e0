from .dense import (dense_flash_attention, dense_flash_bwd, dense_flash_fwd,
                    flash_attention_plain)
from .kernel import flash_attention_varlen, flash_attention_varlen_plain

__all__ = ["dense_flash_attention", "dense_flash_bwd", "dense_flash_fwd",
           "flash_attention_plain", "flash_attention_varlen",
           "flash_attention_varlen_plain"]
