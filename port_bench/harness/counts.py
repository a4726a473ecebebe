"""Operations and bytes worked out from shapes, and the H100's peaks: the
yardstick of the roofline and utilisation metrics.

The bound functions are frozen copies of ``chip_smoke.py``'s
``chain_bound``, ``chain_res_bound``, ``chain_bwd_bound``,
``density_bound`` and ``_bound`` (commit 81ffa68), returning seconds
instead of milliseconds: each input byte read once and each output byte
written once, against the float32 (or float64) operations the kernel's
algorithm needs. The convolution counts are 2 C_in C_out k^2 H_out W_out
a layer and image (a transpose conv 2 C_in C_out k^2 H_in W_in).
"""
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
FP64_FLOP_PER_S = 34e12        # H100 SXM float64, outside the tensor cores


def bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """The least time, s: the larger of bytes over HBM bandwidth and
    operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def _n_j(L):
    return (L + 1) * (4 * (L + 1) ** 2 - 1) // 3


def chain_bound(B, L, C, shared):
    """K1: the Wigner chain of B samples; angles, spectrum and J read, the
    output written; two J products and three z-rotations a sample."""
    S = (L + 1) ** 2
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + _n_j(L) + B * S * C)
    flops = B * (2 * 2 * _n_j(L) * C + 3 * 3 * S * C)
    return bound(nbytes, flops)


def chain_res_bound(B, L, C, shared):
    """K2 forward: the chain's bytes plus its residuals y and z written."""
    S = (L + 1) ** 2
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + _n_j(L) + 3 * B * S * C)
    flops = B * (2 * 2 * _n_j(L) * C + 3 * 3 * S * C)
    return bound(nbytes, flops)


def chain_bwd_bound(B, L, C, shared):
    """K2 backward: angles, x, J, y, z and dout read, dx and d angles
    written; two J products, three z-rotations, three angle
    contractions."""
    S = (L + 1) ** 2
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + _n_j(L) + 3 * B * S * C + B * S * C
                  + 3 * B)
    flops = B * (2 * 2 * _n_j(L) * C + 3 * 3 * S * C + 3 * 6 * S * C)
    return bound(nbytes, flops)


def density_bound(N, B, k, backward, per_row=True):
    """K3 (K4 with ``backward``): the wrapped density of N samples with
    sigma (B, 3); about 30 + 11 (2k+1) float32 operations a sample
    forward, 60 + 17 (2k+1) float64 backward."""
    shells, rows = 2 * k + 1, B if per_row else N
    if backward:
        return bound(4 * (3 * N + 3 * B + rows + 3 * N + 3 * B),
                     N * (60 + 17 * shells), FP64_FLOP_PER_S)
    return bound(4 * (3 * N + 3 * B + rows), N * (30 + 11 * shells))


# ------------------------------------------------------- the conv stacks

def conv_layers(model, size=64):
    """The model's convolutions, input first: dicts of c_in, c_out, k, the
    forward operations of an image (``flops``) and whether the layer's
    input takes a gradient (not the images')."""
    rgb = 3 if model.get("rgb") else 1
    h = model["conv_hidden"]
    layers, c_in, side = [], rgb, size
    for i, w in enumerate([h, 2 * h, 4 * h, 8 * h]):
        side //= 2
        layers.append(dict(part="encoder", c_in=c_in, c_out=w, k=4,
                           flops=2 * c_in * w * 16 * side * side,
                           input_grad=i > 0))
        c_in = w
    out = model.get("group_reparam_in_dims", 10)
    layers.append(dict(part="encoder", c_in=c_in, c_out=out, k=4,
                       flops=2 * c_in * out * 16 * (side - 3) ** 2,
                       input_grad=True))
    d = model["deconv_hidden"]
    spec = (model["degrees"] + 1) ** 2 * model["rep_copies"]
    side = 1
    chans = [(spec, d)] + [(d, d)] * 3 + [(d, rgb)]
    for j, (a, b) in enumerate(chans):
        layers.append(dict(part="decoder", c_in=a, c_out=b, k=4,
                           flops=2 * a * b * 16 * side * side,
                           input_grad=True))
        side = 4 if j == 0 else side * 2
    return layers


def linear_flops(model):
    """The forward operations of an image in the posterior's linear heads
    (the S2xS2 mean's 6 outputs and sigma's 3, from 10 features)."""
    return 2 * model.get("group_reparam_in_dims", 10) * (6 + 3)


def forward_flops(model):
    """Forward operations of one image: convolutions and linear heads."""
    return sum(l["flops"] for l in conv_layers(model)) + linear_flops(model)


def train_conv_flops(model, equivariance):
    """Convolution operations of one training image: forward, the weight
    gradient and the input gradient of every layer but the first's; with
    the equivariance loss the encoder's again for the rotated images."""
    total = 0
    for l in conv_layers(model):
        passes = 2 if (equivariance and l["part"] == "encoder") else 1
        total += passes * l["flops"] * (2 + (1 if l["input_grad"] else 0))
    return total


def train_flops(model, equivariance):
    """Operations of one training image that the forward and backward
    passes need (convolutions and linear heads; the Wigner chain, the
    density and the elementwise work, each under 0.1% of these, left
    out)."""
    lin = 3 * linear_flops(model) * (2 if equivariance else 1)
    return train_conv_flops(model, equivariance) + lin
