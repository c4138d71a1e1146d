"""Franka Panda kinematics: forward kinematics and batched DLS IK."""
