from .kernel import (paged_decode_attention, paged_decode_attention_plain,
                     paged_decode_plan)

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_plan"]
