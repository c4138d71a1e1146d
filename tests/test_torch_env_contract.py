"""The seed contract with the CHOMP expert (`EnvParams()`, the default):
the scenes of `box_asset(0.05, 0.05, 0.14, mass=0.2)` (examples/
minimal_rollout.py's box) that the JAX package's `sample_scene(PRNGKey(s))`
draws for s = 0..7 go through both packages: reset, up to 20 steps of
the planner expert (an env stops once done, as the example breaks),
retract. Each package runs on its own (its own expert actions and random
draws; the draws do not move the physics).

The JAX package itself lifts 6 of these 8 with the planner expert (the
test prints it), so CLAUDE.md's "at least 7 of 8 lift" is not a property
of the reference's planner. What the port must do is give the JAX
package's lift outcome on at least 7 of the 8 seeds (one may differ, as
in tests/test_torch_env_rollout.py: a last-bit IK difference flips one
quantum of the arm servo), with every object below z = 1.0 and every
value finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaddpg_tpu.envs import EnvParams as JaxEnvParams
from gaddpg_tpu.envs import assets as jassets
from gaddpg_tpu_torch.envs.grasp_env import EnvParams, _where
from torch_env_common import jax_retract_batched, make_envs, scenes

SEEDS = tuple(range(8))


def test_planner_seed_contract_lifts_as_jax():
    jenv, env = make_envs(jassets.box_asset(0.05, 0.05, 0.14, mass=0.2), JaxEnvParams(),
                          EnvParams())
    sc = scenes(jenv, SEEDS)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])

    jst, _ = jax.jit(jax.vmap(jenv.reset_scene))(sc, keys)
    j_ok = np.asarray(jst.plan_ok)
    jstep = jax.jit(lambda st, k: jenv.step_batched(st, jax.vmap(jenv.expert_action)(st), k))
    done = np.zeros(len(SEEDS), bool)
    for i in range(20):
        new = jstep(jst, jax.vmap(lambda k: jax.random.fold_in(k, i))(keys))
        jst = jax.tree_util.tree_map(
            lambda a, b: jnp.where(done.reshape(-1, *[1] * (a.ndim - 1)), b, a), new[0], jst)
        done = done | np.asarray(new[3])
    jst, jlift = jax_retract_batched(jenv, jst)

    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset_scene(sc, gen)
    np.testing.assert_array_equal(st.plan_ok.numpy(), j_ok)
    done = torch.zeros(len(SEEDS), dtype=torch.bool)
    for _ in range(20):
        new, _, _, new_done, _ = env.step_batched(st, env.expert_action(st), gen)
        st, done = _where(~done, new, st), done | new_done
    st, lift = env.retract_batched(st)
    lift = lift.numpy()

    z = st.phys.obj.pos[:, 2]
    assert torch.isfinite(st.phys.obj.pos).all() and torch.isfinite(st.phys.arm.q).all()
    assert (z < 1.0).all(), z
    print(f"lifts: JAX {jlift.tolist()} ({int(jlift.sum())} of 8), port {lift.tolist()} "
          f"({int(lift.sum())} of 8)")
    agree = int((lift == jlift).sum())
    assert agree >= 7, f"lifts: port {lift}, JAX {jlift}"
