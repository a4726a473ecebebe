"""Encoder continuity regularizer for paired datasets.

Counterpart of the JAX package's ``losses/continuity.py`` (reference:
EncoderContinuityLoss, lie_vae/losses/encoder_continuity_loss.py:6-35). The
batch is consecutive-pose pairs flattened as (2n, ...) by
``ScPairsDataset.prep_batch``; the loss is the squared distance between
each pair's encodings. The schedule weight is applied by the caller.
"""
import torch


def encoder_continuity_loss(encodings):
    """Returns (mean squared pair distance, per-pair diffs (n,)).

    encodings: (2n, ...) where consecutive rows are pose pairs.
    """
    n = encodings.shape[0] // 2
    enc = encodings.reshape(n, 2, -1)
    diffs = torch.sum((enc[:, 0] - enc[:, 1]) ** 2, dim=-1)
    return torch.mean(diffs), diffs
