"""Geometric separating hyperplanes between agent pairs.

Closed-form, fully vectorised over (horizon, neighbour) — the on-device
equivalent of the reference's double Python loop
(``planner/lib/plan_lib/planes/compute_plane.py:41-68``).

A plane between ego position p and neighbour position q (per horizon step) is
``a = (q - p)/||q - p||``, ``b = -0.5 * a . (p + q)`` so that
``a . x + b = 0`` is the perpendicular bisector: ``a . p + b < 0`` on the ego
side, ``> 0`` on the neighbour side. The sign is flipped when the ego id is
greater than the neighbour id (master/slave convention,
``compute_plane.py:56-63``) unless ``keep_sign``.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


def compute_hyperplanes(ego_xy: jnp.ndarray, neigh_xy: jnp.ndarray,
                        ego_id=None, neigh_ids=None,
                        keep_sign: bool = False) -> jnp.ndarray:
    """Separating planes for each horizon step and neighbour.

    Args:
      ego_xy: (H, 2) ego (x, y) along the horizon.
      neigh_xy: (H, n_neigh, 2) neighbour positions along the horizon.
      ego_id: scalar ego id (only used when ``keep_sign`` is False).
      neigh_ids: (n_neigh,) neighbour ids.
      keep_sign: skip the id-ordered sign flip (reference ``keep_sign``).

    Returns:
      (H, n_neigh, 3) array of (a_x, a_y, b).
    """
    d = neigh_xy - ego_xy[:, None, :]                      # (H, n, 2)
    norm = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    a = d / jnp.maximum(norm, _EPS)
    mid = 0.5 * (neigh_xy + ego_xy[:, None, :])
    b = -jnp.sum(a * mid, axis=-1, keepdims=True)          # (H, n, 1)
    planes = jnp.concatenate([a, b], axis=-1)              # (H, n, 3)

    if keep_sign or ego_id is None or neigh_ids is None:
        return planes
    sign = jnp.where(jnp.asarray(ego_id) < jnp.asarray(neigh_ids), 1.0, -1.0)
    return planes * sign[None, :, None]


def plane_signed_distance(planes: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Evaluate ``a . p + b`` for points against planes (broadcasting)."""
    return (planes[..., 0] * xy[..., 0] + planes[..., 1] * xy[..., 1]
            + planes[..., 2])


def separation_weights(ego_xy: jnp.ndarray, neigh_xy: jnp.ndarray,
                       min_dist) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Distance-based weights for the linear separation reward.

    Reference ``utilities/misc.py:10-18``: weight = (2*D - dist)/n_neigh, so
    close neighbours get pushed away harder. Returns (weights, dist), each
    (H, n_neigh).
    """
    d = neigh_xy - ego_xy[:, None, :]
    dist = jnp.sqrt(jnp.sum(d * d, axis=-1) + _EPS)
    n = neigh_xy.shape[1]
    weights = (2.0 * min_dist - dist) / n
    return weights, dist
