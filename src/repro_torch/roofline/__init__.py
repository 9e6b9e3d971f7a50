"""The planner's roofline (counterpart of `repro.roofline`)."""
from repro_torch.roofline.analysis import (RooflineTerms, collective_bytes,
                                           model_flops, roofline)

__all__ = ["RooflineTerms", "collective_bytes", "model_flops", "roofline"]
