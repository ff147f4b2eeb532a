"""Roofline analysis of the port's step programs on one H100: operation
and byte counts of the eager aten ops (``op_cost``) and the terms
(``analysis``)."""
from repro_torch.roofline.analysis import HW, model_flops, roofline_terms
from repro_torch.roofline.op_cost import analyze_step
