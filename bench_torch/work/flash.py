"""Work of one eval cross-attention call (kernel 3's function,
`flash_attention_packed`), from its logical shapes: q (B, Nq, C), k and v
(B, Nk, C) over H heads, the output (B, Nq, C). Operations: the two
products, 2 * 2 * B * Nq * Nk * C (the softmax's exponentials are not
counted). Bytes: q, k, v and the output once in the compute dtype, and
the per-key bias where one is given."""

TARGETS = (("cmtcoop_tpu_torch.models.petr_decoder",
            "flash_attention_packed"),)


def work(args, kwargs, out):
    q, k, v = args[:3]
    k_bias = args[3] if len(args) > 3 else kwargs.get("k_bias")
    b, nq, c = q.shape
    nk = k.shape[1]
    es = q.element_size()
    ops = 4 * b * nq * nk * c
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * es
    if k_bias is not None:
        nbytes += k_bias.numel() * k_bias.element_size()
    return ops, nbytes
