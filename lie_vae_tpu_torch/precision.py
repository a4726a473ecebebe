"""The port's one float32 precision: IEEE float32 for cuDNN convolutions
and cuBLAS matmuls, never TF32.

torch runs float32 cuDNN convolutions in TF32 by default (10-bit mantissa
inputs), a precision that no check of the port holds against the CPU. The
entry points (``serve.InferenceSession``'s public methods,
``train.train_step``, ``train.UnsupervisedExperiment``, ``cli.main`` and
``cli.serve``) run their device work inside :func:`ieee_float32`, which
sets the two flags for the call and puts the caller's values back after
it, so nothing is set at import and a caller's own settings survive.

It uses torch's ``fp32_precision`` settings (torch >= 2.9) and only those:
reading a legacy ``allow_tf32`` flag after the new settings were written
raises in torch >= 2.9 ("a mix of the legacy and new APIs"), so neither
this module nor its callers touch the legacy flags.
"""
import contextlib

import torch

IEEE = "ieee"


def flags():
    """The two settings as they stand: (cuDNN conv, cuBLAS matmul)."""
    return (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision)


@contextlib.contextmanager
def ieee_float32():
    """Run the block (or, as ``@ieee_float32()``, the function) with float32
    convolutions and matmuls in IEEE float32; restore the caller's settings
    after it, also when it raises."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = flags()
    conv.fp32_precision = matmul.fp32_precision = IEEE
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = saved
