"""Roofline analysis of a counted step (port of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (DEFAULT_HW, H100_SXM, HW, V5E,
                                           RooflineTerms, StepCounter,
                                           collective_bytes, model_flops,
                                           roofline_terms)

__all__ = ["DEFAULT_HW", "H100_SXM", "HW", "V5E", "RooflineTerms",
           "StepCounter", "collective_bytes", "model_flops",
           "roofline_terms"]
