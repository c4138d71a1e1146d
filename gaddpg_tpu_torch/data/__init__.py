"""Data pipelines: mesh import, procedural objects, grasp files and the
grasp-pose dataset (counterpart of gaddpg_tpu/data/).

Meshes become sphere sets, surface samples and grasp sets through the
repository's native host library (`native/mesh_tools.cc`, ctypes, numpy
versions beside it); grasps are verified in the port's contact physics
on the CPU; the grasp-pose dataset renders object clouds in batches on
the caller's device for GoalFeature training.
"""
