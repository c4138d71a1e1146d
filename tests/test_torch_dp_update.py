"""The sharded DDPG and BC updates on 2 gloo ranks against the JAX
package's `make_sharded_update` on 2 virtual CPU devices: the
counterpart of tests/test_mesh.py::test_sharded_matches_single_device
(tests/torch_dp_update_common.py holds the cases and their bounds;
tests/test_torch_dp_update4.py runs them on 4)."""

import pytest

from torch_dp_update_common import Case

WORLD = 2


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    # BC first: its ranks start at once and run while JAX compiles DDPG
    return {kind: Case(kind, WORLD, tmp_path_factory.mktemp(kind)) for kind in ("bc", "ddpg")}


@pytest.mark.parametrize("kind", ["ddpg", "bc"])
def test_sharded_update_matches_jax(kind, cases):
    cases[kind].check()
