"""Tensor ops: pillar machinery and the kernel wrappers."""
