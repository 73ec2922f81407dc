"""Roofline analysis: per-rank op costs counted as the step runs, and the
analytical cost models (``repro.analysis``'s names, with ``step_costs`` in
place of ``parse_hlo_costs``: the port has no HLO to parse)."""
from repro_torch.analysis.op_costs import step_costs
from repro_torch.analysis.roofline import HW, model_flops, roofline_row

__all__ = ["step_costs", "HW", "roofline_row", "model_flops"]
