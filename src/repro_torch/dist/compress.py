"""Int8 error-feedback gradient compression: a port of
``src/repro/dist/compress.py`` (the cross-pod wire format).

Per-leaf symmetric int8 quantization with an error-feedback residual: the
quantization error of step t is added back into the gradient at step t+1,
so the compressed optimizer sees an unbiased long-run gradient (EF-SGD).
The invariant ``dequantize(quantize(x + e)) + e' == x + e`` holds exactly
by construction — e' *is* the representation error.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so codes and scales equal the
reference's on the same float32 inputs.  Trees are the port's
(:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _scale_for(x):
    """Max-abs scale; matrices (ndim >= 2) get one scale per leading-axis
    row — per-tensor scales are far too coarse for gradient trees whose
    leaves mix dense and near-empty rows (e.g. embeddings)."""
    xf = x.float()
    if xf.dim() >= 2:
        amax = torch.amax(torch.abs(xf), dim=tuple(range(1, xf.dim())), keepdim=True)
    else:
        amax = torch.amax(torch.abs(xf))
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _encode(x, scale):
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


def quantize_int8(x):
    """Symmetric max-abs int8 quantization: returns (codes int8, scale)."""
    scale = _scale_for(x)
    return _encode(x, scale), scale


def dequantize_int8(q, scale):
    return q.float() * scale


def ef_quantize(x, err):
    """Quantize ``x + err``; returns (codes, scale, new residual)."""
    y = x.float() + err
    q, scale = quantize_int8(y)
    return q, scale, y - dequantize_int8(q, scale)


def init_error_tree(params):
    """Zero residual buffers matching ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_tree(grads, ef=None):
    """Compress a gradient tree with error feedback.

    Returns ``(payload, ef_new)`` where ``payload = (codes_tree,
    scales_tree)`` is what crosses the wire and ``ef_new`` carries the
    residuals into the next step."""
    if ef is None:
        ef = init_error_tree(grads)
    y = tree_map(lambda g, e: g.float() + e, grads, ef)
    scales = tree_map(_scale_for, y)
    codes = tree_map(_encode, y, scales)
    ef_new = tree_map(lambda v, q, s: v - dequantize_int8(q, s), y, codes, scales)
    return (codes, scales), ef_new


def decompress_tree(payload):
    codes, scales = payload
    return tree_map(dequantize_int8, codes, scales)
