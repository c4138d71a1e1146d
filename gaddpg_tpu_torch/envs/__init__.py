"""The batched Panda grasping env and its object library."""
