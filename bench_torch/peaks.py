"""Published peaks of the cards the benchmark knows, by the name that
`torch.cuda.get_device_name()` gives (NVIDIA's H100 data sheet, the SXM
part, dense rates without sparsity, at the full 700 W power limit). A card
not named here gets no roofline or utilisation reading."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_ops_per_s": 989e12,
                              "bytes_per_s": 3.35e12},
}


def peaks(kind: str):
    return PEAKS.get(kind)


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory bandwidth."""
    return max(ops / peak["bf16_ops_per_s"], nbytes / peak["bytes_per_s"])
