"""Detection scoring."""
