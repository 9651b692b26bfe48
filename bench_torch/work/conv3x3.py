"""Work of one 3x3 conv + folded BN + ReLU call (kernel 4's function),
from its logical shapes: the NHWC input (N, H, W, Cin), the output
(N, H, W, Cout) and the (Cout, Cin, 3, 3) weight. Operations: 2 * N * H *
W * Cout * Cin * 9. Bytes: the input, the weight, a residual where one is
given and the output, each once, in the compute dtype; the folded BN's
float32 scale and shift."""

# (module, attribute): the program's calls of the function, one span each
TARGETS = (("cmtcoop_tpu_torch.models.vovnet", "conv3x3_bn_relu_packed"),
           ("cmtcoop_tpu_torch.models.layers", "conv3x3_bn_relu_packed"))


def work(args, kwargs, out):
    """(operations, bytes) of one call."""
    x = args[0]
    n, h, w, cin = x.shape
    cout = out.shape[-1]
    es = x.element_size()
    ops = 2 * n * out.shape[1] * out.shape[2] * cout * cin * 9
    residual = kwargs.get("residual", args[3] if len(args) > 3 else None)
    nbytes = (x.numel() + cout * cin * 9 + out.numel()) * es + 2 * cout * 4
    if residual is not None:
        nbytes += residual.numel() * es
    return ops, nbytes
