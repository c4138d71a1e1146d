"""Rigid-body physics of the single-object grasp: the arm as a
position servo, the target as a free body with compliant contacts
against the table, the two finger pads and the palm (counterpart of
gaddpg_tpu/physics/, batched path only)."""
