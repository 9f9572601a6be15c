"""Roofline analysis: the reference's HLO collective parser, the port's
collective log, and the H100's roofline terms."""
from .analysis import (collective_bytes_from_hlo,  # noqa: F401
                       collective_bytes_from_log, recommend_execution,
                       roofline_terms, summarize_combo)
