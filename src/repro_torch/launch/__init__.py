"""Launch-side analysis the port needs: the H100's roofline constants and
the analytic parameter count (``roofline``)."""
from .roofline import HBM_BW, PEAK_FLOPS, count_params

__all__ = ["HBM_BW", "PEAK_FLOPS", "count_params"]
