"""Behaviour-cloning update (counterpart of gaddpg_tpu/agents/bc.py;
reference: core/bc.py:11-56).

The policy phase of DDPG without the critic: PM BC loss on expert
transitions (with no (1 - mix) factor), the grasp-aux PM loss and the
collision aux loss, stepping the policy and the policy encoder. The
collision term is reported on its own. Under a data-parallel mesh it
runs as the DDPG update does (agents/ddpg.py).
"""

from gaddpg_tpu_torch.agents.config import AgentConfig
from gaddpg_tpu_torch.agents.ddpg import (
    _check_inputs, _grads, _masks, _metrics, _policy_losses, resolve_update_device,
)
from gaddpg_tpu_torch.agents.state import AgentState, check_supported
from gaddpg_tpu_torch.parallel.mesh import sum_grads
from gaddpg_tpu_torch.utils.precision import f32_matmuls

BC_SUMMED = ("bc_loss", "policy_grasp_aux_loss", "collision_aux_loss", "expert_mask_num")


def make_bc_update(cfg: AgentConfig = AgentConfig(), device="cuda", mesh=None):
    """Build `update(state, batch) -> metrics`, which takes one BC step on
    `state` in place (policy and encoder parameters, the encoder's
    running statistics, their optimizers, update_step). `batch` holds
    point_state (in image mode image_state), time, expert_action, goal,
    return, expert_flags and, when a collision term is on, collide_future,
    on `device`; with a data-parallel `mesh`, this rank's rows of it
    (`make_ddpg_update` says how the ranks share the update)."""
    check_supported(cfg)
    device = resolve_update_device(device, mesh)

    @f32_matmuls
    def update(state: AgentState, batch):
        _check_inputs("bc update", state, batch, device)
        m = _masks(batch)
        _, stats, bc, aux, collision = _policy_losses(cfg, state, batch, m, 1.0, mesh)
        p_params, e_params = state.opt["policy"].params, state.opt["encoder"].params
        grads = sum_grads(mesh, _grads(bc + aux + collision, p_params + e_params),
                          p_params + e_params)
        state.opt["policy"].step(grads[:len(p_params)])
        state.opt["encoder"].step(grads[len(p_params):], apply=cfg.train_feature)
        state.feat.encoder.update_running_stats(stats)
        state.update_step += 1
        metrics = {
            "bc_loss": bc,
            "policy_grasp_aux_loss": aux,
            "collision_aux_loss": collision,
            "expert_mask_num": m["expert"].sum(),
        }
        return _metrics(metrics, device, mesh, BC_SUMMED)

    update.mesh = mesh
    return update


def bc_update(cfg: AgentConfig = AgentConfig(), device="cuda", mesh=None):
    """The built BC update (`make_bc_update`), as the JAX package's
    `bc_update` returns its jitted update."""
    return make_bc_update(cfg, device, mesh=mesh)
