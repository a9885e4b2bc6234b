"""Trace-to-trace transforms (reference: thunder/core/transforms.py,
transform_common.py)."""
