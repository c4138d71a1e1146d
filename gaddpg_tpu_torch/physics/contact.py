"""The passive contact clamp (counterpart of
gaddpg_tpu/physics/contact.py:34-54; the rest of that module serves the
per-env physics, which is not ported)."""

import torch


def clamp_passive_delta(dv, v, dv_max, eps=1e-9):
    """Constrain a contact-driven velocity delta to passive behaviour.

    Decomposed against the current velocity v: the braking component
    (along -v) may run to full reversal plus a dv_max margin, so an
    incoming object is always stopped, never tunnels; the
    speed-increasing components (along +v and perpendicular) are capped
    at dv_max per substep. Penalty springs backed by the position-servo
    arm are an unbounded energy source; this keeps a deep squeeze or
    table press from releasing as an ejection.

    Broadcasts over leading batch axes; the last axis is the vector.
    `dv_max` is a float or a tensor broadcasting against (..., 1).
    """
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v_hat = v / torch.clamp(vn, min=eps)
    along = torch.sum(dv * v_hat, dim=-1, keepdim=True)
    perp = dv - along * v_hat
    pn = torch.linalg.vector_norm(perp, dim=-1, keepdim=True)
    along_c = torch.minimum(torch.maximum(along, -(vn + dv_max)), torch.as_tensor(dv_max).to(along))
    perp_c = perp * torch.clamp(dv_max / torch.clamp(pn, min=eps), max=1.0)
    return along_c * v_hat + perp_c
