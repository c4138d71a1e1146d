"""Grasp-goal selection and the goal-servo expert."""
