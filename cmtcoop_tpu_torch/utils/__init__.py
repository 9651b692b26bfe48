"""Host utilities: preset overrides, TensorBoard events, timing."""
