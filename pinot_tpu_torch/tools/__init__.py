"""Operator tools: the admin CLI (`admin.py`) and the segment tools (`segment.py`)."""
