from .kernel import flash_attention_varlen, flash_attention_varlen_plain

__all__ = ["flash_attention_varlen", "flash_attention_varlen_plain"]
