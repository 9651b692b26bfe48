"""Host-side (numpy) transforms of the data pipeline and the GT-paste
sampler."""
