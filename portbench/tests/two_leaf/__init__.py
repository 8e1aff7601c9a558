"""A configuration the harness has never seen, added as files alone: its
own task (``tasks/scaled_fit.py``: two leaves of different shapes, a loss
other than 1 - IoU) and plain reference (``reference/scaled_fit.py``),
its configuration and its limits, laid out as ``portbench/`` and found
through ``spec``'s ``home``."""
