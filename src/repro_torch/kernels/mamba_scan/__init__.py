from .kernel import (mamba_chunk_scan, mamba_chunk_scan_bwd,
                     mamba_chunk_scan_bwd_plain, mamba_chunk_scan_plain,
                     mamba_chunk_scan_train, mamba_chunk_scan_varlen,
                     mamba_chunk_scan_varlen_plain)

__all__ = ["mamba_chunk_scan", "mamba_chunk_scan_bwd",
           "mamba_chunk_scan_bwd_plain", "mamba_chunk_scan_plain",
           "mamba_chunk_scan_train", "mamba_chunk_scan_varlen",
           "mamba_chunk_scan_varlen_plain"]
