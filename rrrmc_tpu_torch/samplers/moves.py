"""Batched move-selection primitives shared by the generic samplers.

The reference keeps O(1)-updatable class buckets or partial-sum trees to
serve a serial loop. Over a batch of chains the same distribution, pick
spin i with probability min(1, e^{-beta dE_i}) / z, is computed directly
from the dense [B, N] dE tensor.

The primitives take their uniforms as tensors ([B], one per chain), so the
caller owns the generator and a test can feed the JAX package's primitives
and these the same numbers. Arithmetic runs in the inputs' dtype.
"""

from __future__ import annotations

import torch


def acceptance_weights(dE_physical, beta):
    """w_i = min(1, e^{-beta dE_i}) (the reference's `prior`)."""
    return torch.exp(torch.clamp(-beta * dE_physical, max=0.0))


def categorical_from_weights(u, w):
    """Per chain, the index drawn proportionally to non-negative weights
    w [B, N] by inverse CDF (cumsum + searchsorted), with u [B] uniform in
    [0, 1). Returns (i [B] int64, z [B])."""
    c = torch.cumsum(w, dim=-1)
    z = c[..., -1]
    t = (u.to(c.dtype) * z)[..., None]
    i = torch.searchsorted(c, t, right=True)[..., 0]
    return i.clamp(0, w.shape[-1] - 1), z


def geometric_skip(u, p):
    """Number of rejected virtual iterations before an accepted BKL move:
    skip ~ Geometric(p), P(skip=k) = (1-p)^k p (the reference's rand_skip),
    p = z/N in (0, 1]. Returns int64."""
    eps = torch.finfo(u.dtype).tiny
    denom = torch.log1p(-torch.clamp(p, max=1 - 1e-12))
    skip = torch.floor(torch.log(torch.clamp(1 - u, min=eps)) / denom)
    skip = torch.where(p >= 1.0, torch.zeros_like(skip), skip)
    return skip.to(torch.int64)


def accept_factor(u, c, x):
    """Accept with probability min(1, c * e^x) (the reference's
    `accept(c, x)`), in the log domain: u < c e^x <=> log u < log c + x,
    exact at any magnitude of c and x."""
    return torch.log(u) < torch.log(c) + x


def inner_view(model):
    """(inner model, aux projection): the identity for single models, the
    exactly-sampled part of a Double and its aux for composites."""
    inner = model.inner
    if inner is None:
        return model, (lambda aux: aux)
    return inner, model.inner_aux


def select_state(pred, new, cur):
    """Per chain b, `new` where pred[b] else `cur`, written into `cur` in
    place: a state tensor whose axis 0 holds each chain's rows together
    (B rows, or B * M for a replica composite's base aux), or a tuple of
    them (a composite's aux). Returns `cur`."""
    if isinstance(cur, tuple):
        for a, b in zip(new, cur):
            select_state(pred, a, b)
        return cur
    if torch.is_tensor(cur):
        rows = pred.repeat_interleave(cur.shape[0] // pred.shape[0])
        mask = rows.view((-1,) + (1,) * (cur.ndim - 1))
        cur.copy_(torch.where(mask, new, cur))
    return cur
