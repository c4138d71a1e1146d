"""The seed contract of the env port (CLAUDE.md "Conventions", ROADMAP
"Behavioural contracts"): scenes of `box_asset(0.05, 0.05, 0.14)` drawn by
the JAX package's `sample_scene(PRNGKey(s))` for s = 0..7 go through
both packages with `EnvParams(use_planner=False)`: reset, 20 steps of
the goal-servo expert, retract. Each package runs on its own (its own
expert actions and random draws; the draws do not move the physics).

The port must give the JAX package's lift outcome on at least 7 of the
8 seeds, with every object below z = 1.0 (the ejection guard) and every
value finite. One seed may differ: a last-bit difference in the IK's
servo target flips one quantum of the arm servo (see
tests/test_torch_env.py), and twenty steps and a lift can carry that
into a grasp that holds in one package and slips in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaddpg_tpu.envs import assets as jassets
from torch_env_common import jax_retract_batched, make_envs, scenes

SEEDS = tuple(range(8))


def test_seed_contract_lifts_as_jax():
    jenv, env = make_envs(jassets.box_asset(0.05, 0.05, 0.14))
    sc = scenes(jenv, SEEDS)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])

    jst, _ = jax.jit(jax.vmap(jenv.reset_scene))(sc, keys)
    valid = np.asarray(jst.valid_scene)
    jstep = jax.jit(lambda st, k: jenv.step_batched(st, jax.vmap(jenv.expert_action)(st), k)[0])
    for i in range(20):
        jst = jstep(jst, jax.vmap(lambda k: jax.random.fold_in(k, i))(keys))
    jst, jlift = jax_retract_batched(jenv, jst)

    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset_scene(sc, gen)
    np.testing.assert_array_equal(st.valid_scene.numpy(), valid)
    for _ in range(20):
        st = env.step_batched(st, env.expert_action(st), gen)[0]
    st, lift = env.retract_batched(st)
    lift = lift.numpy()

    z = st.phys.obj.pos[:, 2]
    assert torch.isfinite(st.phys.obj.pos).all() and torch.isfinite(st.phys.arm.q).all()
    assert (z < 1.0).all(), z
    agree = int((lift == jlift).sum())
    assert agree >= 7, f"lifts: port {lift}, JAX {jlift}"
