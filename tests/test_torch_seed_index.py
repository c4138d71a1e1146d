"""The manifest rule's negative control on a whole build: a seed index
the JAX package writes for seed 1, whose labels sit away from the rig's
threshold, with its grasp count raised by 2. The port rebuilds the
object, finds the count off, reruns the rig with the sphere centres one
ulp up and down, finds fewer than 2 uncertain labels
(`mesh_import.uncertain_labels`) and must refuse the index with the
RuntimeError of gaddpg_tpu/data/procgen.py:339-352
(tests/test_torch_grasp_verify.py holds the rule's acceptance)."""

import json

import pytest

from gaddpg_tpu_torch.data import procgen
from torch_grasp_common import jax_seed_index


def test_count_off_by_two_is_refused(tmp_path):
    path = jax_seed_index(tmp_path / "idx.json", 1, 0, seed0=1)
    with open(path) as f:
        idx = json.load(f)
    (entry,) = idx["train"]
    assert entry["name"] == "proc_revolution_0001"
    entry["grasps"] += 2
    with open(path, "w") as f:
        json.dump(idx, f)
    report = []
    with pytest.raises(RuntimeError, match="do not reproduce the manifest"):
        procgen.library_from_seed_index(path, "train", report=report)
    (r,) = report
    assert r["built"] == entry["grasps"] - 2
    assert int(r["uncertain"].sum()) < 2
