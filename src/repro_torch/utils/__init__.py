"""Counts of a step's work: the H100's roofline (``roofline.py``), the
analytic estimate of a cell (``flops.py``) and the counting dispatch mode
that walks a step on the meta device or the card (``cost.py``)."""
